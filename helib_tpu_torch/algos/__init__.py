"""The algorithm library on slots (helib_tpu.algos): totalSums, runningSums
and replication so far."""
