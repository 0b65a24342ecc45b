"""Command-line tools of the PyTorch port (ports of the JAX package's `tools/`)."""
