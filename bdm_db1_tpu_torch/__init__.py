"""PyTorch/CUDA port of bdm_db1_tpu, slice 1: RL-evaluation decode.

Module names mirror the JAX package (``bdm_db1_tpu``), which stays the
reference; this package imports neither JAX nor anything of that package.
"""
