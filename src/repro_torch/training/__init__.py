"""Training utilities of the port: optimizers (``optim``), the data
pipeline (``data``) and checkpoints (``checkpoint``)."""
