"""The algorithm library on slots (helib_tpu.algos): sums, replication,
matrix products, linearized polynomials, digit extraction, permutation
networks, binary circuits, table lookup, equality testing, intraslot
packing and the encrypted database query."""
