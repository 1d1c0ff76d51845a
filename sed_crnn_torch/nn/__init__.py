"""nn layer of the PyTorch port."""
