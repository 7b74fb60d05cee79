"""data (PyTorch port)."""
