"""The benchmark of helib_tpu_torch (see run.py)."""
