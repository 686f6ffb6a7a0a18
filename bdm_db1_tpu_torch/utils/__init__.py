"""utils of the PyTorch port (counterpart of bdm_db1_tpu/utils)."""
