"""portbench: the benchmark of the PyTorch/CUDA port (README.md)."""
