"""train (PyTorch port): the Mask R-CNN training loop and checkpoints."""
