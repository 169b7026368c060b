"""slam of the PyTorch/CUDA port."""
