"""fusion (PyTorch port)."""
