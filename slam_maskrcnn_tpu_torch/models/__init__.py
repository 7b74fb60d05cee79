"""models (PyTorch port)."""
