"""Kernels and plain ops of the PyTorch port (device code is built at first use)."""
