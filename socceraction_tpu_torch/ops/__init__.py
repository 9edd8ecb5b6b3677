"""Device kernels and their plain PyTorch versions."""
