"""Training utilities of the port: the Adam optimizer."""
