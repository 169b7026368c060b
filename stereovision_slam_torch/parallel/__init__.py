"""parallel of the PyTorch/CUDA port: the (dp, mp) mesh, the ring
all-reduce (kernel D, `csrc/ring_reduce.cu`), sharded BA and sharded PGO."""
