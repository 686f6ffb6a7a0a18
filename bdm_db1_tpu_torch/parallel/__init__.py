"""parallel of the PyTorch port (counterpart of bdm_db1_tpu/parallel): the
process world, the device mesh's shape and the partitioning arithmetic."""
