"""geometry of the PyTorch/CUDA port."""
