"""PyTorch/CUDA port of `hept_tpu` for one NVIDIA H100.

The package mirrors `hept_tpu`'s layout (core/, ops/, models/, data/, train/,
utils/) and holds the training steps of the `hept_acc`, `hept_fast` and
`hept_turbo` profiles (static bucket plan) and of the reference-parity
`hept` profile (dynamic per-layer keys), with synthetic tracking events, the
windowed InfoNCE loss and Adam, and their evaluation path (kNN retrieval
metrics, the best-by-valid run with checkpoints); the row-major
reference-pipeline core `ops/bucket_attn.py:hept_attention_core` and the
per-row sort `ops/sort.py:bitonic_sort_rows`; batches of events as one
flat forward and the parallel modes (`parallel/`: data parallelism and
head / hash tensor parallelism on `torch.distributed`). Every TPU kernel of the JAX
package has a hand-written CUDA counterpart (`csrc/`), built with `nvcc` on
first use and loaded with ctypes; on CPU tensors every kernel wrapper runs
its plain PyTorch version instead.

Importing the package touches no GPU and builds nothing. It turns TF32 off
for float32 matmuls and convolutions: the reference asks for full-f32
products (`Precision.HIGHEST`) wherever it computes in float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
