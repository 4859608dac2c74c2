"""Multi-process training (port of `hept_tpu/parallel/`: the mesh, DP, head /
hash TP, the head-sharded attention and the bucket-axis SP with its
distributed sort) on `torch.distributed` process groups: NCCL for CUDA
tensors, gloo for CPU tensors."""
