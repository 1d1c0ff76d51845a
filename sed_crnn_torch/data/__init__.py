"""data layer of the PyTorch port."""
