"""Multi-process training (port of `hept_tpu/parallel/`: the mesh, DP, head /
hash TP and the head-sharded attention) on `torch.distributed` process
groups: NCCL for CUDA tensors, gloo for CPU tensors. The bucket-axis SP
(`bp.py`, `dsort.py`) is not ported yet."""
