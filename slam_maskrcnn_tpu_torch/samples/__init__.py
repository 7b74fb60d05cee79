"""samples (PyTorch port)."""
