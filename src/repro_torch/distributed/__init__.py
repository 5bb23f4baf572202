"""Distribution layer of the PyTorch port: the seed-parallel ``fanout``."""
