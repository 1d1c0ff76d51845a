"""Measurement tools of the PyTorch port, run by hand on a CUDA card."""
