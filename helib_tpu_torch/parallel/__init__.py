"""The parallel layer on torch.distributed (helib_tpu.parallel): a
("batch", "limb") mesh of ranks (mesh.py), the phi(m)-axis four-step
transform (sharded_ntt.py) and the process group (distributed.py)."""
