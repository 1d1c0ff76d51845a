"""apps layer of the PyTorch port."""
