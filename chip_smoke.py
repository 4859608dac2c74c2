#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`hept_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 5] [--points 60000] [--seed 0]

Phases, one line each (plus per-kernel lines):
  1. build the CUDA kernels from `hept_tpu_torch/csrc` (four sources, one
     nvcc each, in parallel) and the native host library
     (`hept_tpu_torch/native`, g++; the synthetic pairs' backend), and
     print the card's name and power limit;
  2. hold every kernel of the ported paths (K1-K7) against its plain PyTorch
     version at the paths' shapes, with the tolerance printed beside
     the error, and time kernel, plain version and, where one exists, the
     single PyTorch call computing the same function; K2 and K7 v2 also
     against the f32 autograd gradient of the bf16 forward (the
     bf16-gradient contract); K1 / K2 on the tensor-core route (bf16) with
     the same bits on repeated calls, timed by CUDA events and by CUDA graph
     replay beside their bound and their per-logit ex2 / FP32 floors, then on
     the scalar route (f32) at the same shape, checked and timed once; K1's
     library yardstick (`library_yardstick`: efficient attention over the
     buckets' augmented columns, the same function up to one rescale); K3
     bit-equal to its plain version at d = 12 and 1 on the batch's index,
     at d = 7 on an emb 4 bytes into a larger buffer and with indices out
     of range (NaN rows), timed at both widths (`k3_yardsticks`) beside its
     bound and `index_select`; K4 with its CSR given and building its own,
     on the batch's index and an unsorted one, the same bits on repeated
     calls, then timed (`k4_yardsticks`: the kernel at d = 12 and 1, the
     CSR build, the loss's three calls against three `index_add_`); K5 (the
     unsort row gather) exactly, on bf16 and f32 rows, the forward's and the
     backward's index, a broadcast source and a ragged n, then at the five
     row shapes the paths move (K5_SHAPES, seven), exactly and timed against
     `index_select`; kernel times both by CUDA events around calls in a row
     and by CUDA graph replay (device time); K6 / K7 (the small-bucket
     column kernels) at the parity profile's shapes in f32 and hept_fast's
     in bf16, in K6's three modes and both K7 variants, and on a ragged
     bucket count; K6 and K7 each on its routes (bf16 K6 and K7 v2 on the
     tensor cores, f32 K6 and K7 v1 on FP32 FMAs) with the same bits on 4
     calls, timed by CUDA graph replay; K6 and K7 v2 on the tensor cores
     against the f32 forward / autograd of the same bf16 values at a
     per-bucket common mode of 40; K6's library yardstick at both shapes;
     then K6 and K7 again at the pileup width d = 28 (coords_dim 4), on the
     routes and modes the pileup paths run (f32 K6 / K7 v1, bf16 K6 exact
     bias / K7 v2, ragged, common mode 40; rows K6d28 / K7d28);
  3. the main path: the full-width `hept_acc` model (random weights from the
     seed) takes `--steps` Adam steps at lr 1e-2 with dropout on, through the
     trainer's `train_step`, on one synthetic 60k-point event; launch
     counters are zeroed just before and read just after (per step K1 and
     K2 4 each on the tensor-core route and none on the scalar one, K5 8, K3
     3 (2 of them at d = 1), K4 3, one CSR build);
  4. the first step's loss and gradients again, dropout off, once with the
     kernels and once with the plain versions, compared: in the hept_acc
     configuration, and with its bf16 modes off (f32 kernels: K1 / K2 4 each
     on the scalar route);
  5. the eval path: the trainer's `evaluate` (forward, loss, retrieval
     metrics) on the same event with the phase-3 weights, timed, with the
     metrics' share; launch counters zeroed just before (K1 on the
     tensor-core route and K5: 4 per event);
     then the same under `plain_reference()`, compared;
  6. the trainer: `run_one_seed` for one epoch on a 3-event synthetic
     dataset in a temporary log dir: it writes a checkpoint, restores it
     into a fresh model and re-evaluates; the re-eval must equal the
     in-loop best test metrics;
  7. the reference-parity `hept` profile (dynamic per-layer keys, f32, K6 /
     K7 v1) and 8. the `hept_fast` profile (bf16, K6 / K7 v2): each takes
     `--profile-steps` Adam steps at full width on one synthetic 60k event
     (block_size 100), timed, with launch counters zeroed just before and
     read just after (K6 4 and K7 4 on their routes' counters, `cols_fwd` /
     `cols_bwd` for the parity profile and `cols_fwd_tc` / `cols_bwd_tc`
     for hept_fast, none on the others, K5 8 per step, K1/K2 none); one
     timed `evaluate` of the event, counters zeroed just before (K6 4 on its
     route, K5 4, K7 and K1/K2 none); then its
     first step, dropout off, with kernels and under `plain_reference()`,
     compared (the parity run on the kernel run's permutations);
  9. the row-major core `hept_attention_core` (kernel K10) forward and
     backward at the parity width on the bs-100 event (layer 0's q/k/v of
     the parity model), launches counted, against `plain_reference()` on the
     same permutations; then K10 alone on its sorted operands: against its
     plain version and float64, the same bits on 4 calls, on the tiled
     forward route the bits of K6 f32 on the transposed operands, timed by
     CUDA graph replay and events, the forward beside its library
     yardstick (g batches of one bucket), each with the route it took;
 10. `attn_impl: slab` and `hybrid_slab` (the TPU's slab kernels K8/K9, run
     as K6 hi/lo + K7 v1 and K6 + K7 v1): one hept_fast step each, launches
     counted (K6 on the tensor cores), kernels against plain versions;
 11. K12 (`bitonic_sort_rows`) on 24 rows of 60000 keys with 16 payloads
     (the cluster route), launches counted per route, bit-equal to its plain
     version, timed by CUDA graph replay against torch.sort and the
     payload gathers; then the bitonic route at 4 rows of 70000 keys;
 12. `hept_max` (hept_acc at OR width 3 over 12 static rounds) on the
     phase-3 event: `--profile-steps` steps, launches counted (K1 / K2 4
     each a step on the tensor-core route), one `evaluate`, the first step
     with kernels against plain versions (as phase 4 holds hept_acc);
 13./14. the pileup task on one synthetic 60k pileup event (block_size
     100, PID embedding, sigmoid head, focal loss on the neutral points):
     the parity `hept` profile (K6 / K7 v1 on FP32 FMAs at d = 28) and
     `hept_fast` (K6 / K7 v2 on the tensor cores), each `--profile-steps`
     Adam steps at lr 1e-3 with launches counted (K6 4, K7 4 a step on
     their routes' counters, K5 8, K1-K4 none), one timed `evaluate` (K6 4,
     K5 4) against `plain_reference()` (loss 1e-3 relative, AP / ROC-AUC /
     F1 5e-3), then the first step with kernels against plain versions;
 15. the pileup trainer: `run_one_seed` (hept_fast) for one epoch on three
     synthetic 60k pileup events, checkpoint restored and re-evaluated to
     the in-loop best test metrics (AP included);
 16./17. the seven baseline attentions (performer, flt, reformer, smyrf, sb,
     pct, flatformer; `models/attention/`, plain PyTorch) at their YAMLs'
     widths and lr, 16 on the bs-100 tracking event (2 Adam steps each,
     dropout and the LSH draws from the step's generator; K3 / K4 counted as
     the loss launches them, no other kernel), 17 on the pileup event (1
     step, no kernel): one more step under torch.profiler (device busy ms,
     K3 / K4 ms), peak GiB, one timed `evaluate` against
     `plain_reference()` (loss 1e-3, metrics 5e-3), the first step with
     kernels against plain (f32 levels; the LSH baselines on the kernel
     run's sort orders); a table line per baseline with the card's name
     and power limit;
 18./19. the four GNN baselines (GatedGNN, GCN, DGCNN, GravNet;
     `models/gnns.py`, plain PyTorch message passing) from their YAMLs
     (`configs/<task>/<task>_gnn_<conv>.yaml`) on the same two events, as
     16 / 17 run the baselines (18: 2 steps, K3 / K4 as PAIR_LAUNCHES_STEP,
     no other kernel; 19: 1 step, no kernel), with torch.topk's device time
     (the learned-space kNN of DGCNN / GravNet) from the profiled step; a
     table line per GNN and task;
 20. each baseline and each GNN (tracking, 2 layers) on a 1200-point event
     on the CPU and on the card, the same weights and fixed draws, the
     CPU's sort orders, graph and neighbour lists imposed: outputs to 1e-4
     of their scale, whether two card calls gave the same bits;
 21. `run_one_seed` of `tracking_gnn_gravnet.yaml` (as the CLI's -c loads
     it) for one epoch on 3 events of its dataset's generator (6000
     points), checkpoint restored and re-evaluated to the in-loop best;
 22. the trainer's options on the full-width hept_acc model and the phase-3
     event: one step each of the InfoNCE with dist_metric cosine and
     l2_inverse (K3 3, K4 4: `partner_gather`'s backward is a K4 at d = 12),
     of the triplet loss and of `windowed_pairs: false` (no K3 / K4), each
     one's first step with kernels against plain; three AdamW steps under
     the per-step cosine schedule with clip_norm, each lr held to the
     formula, the clipped gradient with kernels against plain;
 23. flat batching: the hept_acc model on two 60k events (seeds `--seed`
     and `--seed` + 1) as one forward of 2 x 60416 points (`batch_mode:
     flat`) and stacked (`sort_events` 2): the first step, dropout off,
     flat against the event loop and against `plain_reference()`, stacked
     against the loop (loss 1e-3, gradients 1e-2 relative L2); then
     `--profile-steps` Adam steps each of the flat batch, the loop batch and
     one event, launches counted (a flat step: K1 / K2 4 each, K5 8), one
     more under torch.profiler (device busy ms), peak GiB;
 24. DP at world 1 over NCCL: 3 hept_acc steps through `train_step` with
     the one-rank data group, bit-equal to the plain step on a copy of the
     model (loss, gradient norm, every parameter), step ms of each;
 25.-27. two processes of this script (`--rank-worker`) share the card in
     a gloo group (NCCL refuses two ranks on one device), each with a join
     timeout: 25 DP, hept_acc, an event a rank, one Adam step against the
     single-process step of both events (loss 1e-3, averaged gradient and
     parameter update 1e-2 relative L2; K1 / K2 4 each a rank); 26 TP, the
     parity profile with shard_heads 2 (4 heads a rank) on the bs-100 event
     and the reference's permutations, against the single-process step
     (loss 1e-4, every parameter gradient 1e-3 of its scale; K6 f32 and K7
     v1 4 each a rank); 27 SP, `head_sharded_attention` (14400 buckets of
     100, f32) against the unsharded core on the card (output 1e-5,
     input gradients 1e-4 of scale; K10 one each way a rank). The two-rank
     phases are correctness evidence: two ranks sharing one card measure
     no scaling;
 28. the dynamic-key share_heads model (the parity YAML + qkv_post_sort,
     shared_sort, share_heads; f32) on the bs-100 event: `--profile-steps`
     Adam steps with dropout (K6 f32 / K7 v1 4 each and K5 8 a step), one
     more under torch.profiler (device busy ms), the first step with
     kernels against plain on the kernel run's sort orders (loss 1e-4,
     gradients 1e-3 of scale);
 29. its bucket train step (`parallel/bp.py:make_bucket_train_step`) at
     world 1 over NCCL, each transport, from phase 28's weights and dropout
     seed: every step's (loss, grad_norm) and every parameter after the last
     the same bits as phase 28's (K5 8 a step replicated, none distributed);
 30. (in the two-rank spawn of 25-27) bucket shards 2: the bucket-sharded
     core (300 buckets of 100 a round and head a rank) forward and backward
     each transport against the single-process core (output 1e-5, input
     gradients 1e-4 of scale; K6 / K7 one each a rank), the overflow case
     (cap_factor 1e-6) NaN, and one `make_bucket_train_step` step a
     transport against the single process (loss 1e-5 relative, gradients
     1e-4 of scale; K6 / K7 4 each a rank), a rank's ms;
 31. a reference-layout `data.pt` written on the host and read through
     `get_dataset`, one parity step on the card on an event of it, and
     `scripts/hept_example.py` at 2000 points on the card;
 32. zero padding (the reference's src variant) on the bs-100 event: the
     parity YAML with padding_mode zero, `--profile-steps` steps (K6 f32 /
     K7 v1 4 each, K5 8 a step), one profiled step (busy ms), the first
     step against plain at phase 7's gates; one zero-padded hept_acc step
     on the bs-512 event (K1 / K2 4 each on the tensor cores) against
     plain at phase 4's bf16 gates;
 33. dynamic keys after the sort, f32: per-head keys (the parity YAML +
     qkv_post_sort) and shared_sort, each as phase 32's parity; the
     gather_sort twin of each and of phase 28's share_heads model the same
     bits as its sort-carry run (K5 24, 16 and 16 a step); phase 28's model
     with fold_unsort (which runs the head-broadcast carry) phase 28's bits;
 34. hept_fast's modes on dynamic keys (phase 28's model + sort_pack,
     unsort_pack, kernel_bf16, kernel_center; attn_impl hybrid2): steps
     with K6 bf16 / K7 v2 on the tensor cores, busy ms, the first step
     against plain at phase 8's bf16 gates, its gather_sort twin (bf16 60 B
     rows) the same bits, and the model-level bf16-gradient check (the
     gradient against autograd of the same bf16 forward);
 35. use_ckpt: one step each of hept_acc, parity and reformer without and
     with it, the same bits and the generator's state, and the peak memory
     of each;
 36. the static-plan family, at the JAX demo's arms
     (`scripts/train_60k_demo.py:arm_config`): static, full (canon_residual),
     fullb4, coordsb4 (static_and_bins, the "coords" hash), full +
     unsort_rows, static + fold_unsort, the fp8 unsort on the
     `validate_fp8_unsort` model (dynamic keys) and on static, on the bs-100
     event (attn_impl hybrid: K6 bf16 on the tensor cores and K7 v1, 4 each
     a step), and nh2r8bs512cv2rg2 / rg4 (transport groups) on the bs-512
     event (K1 / K2 4 each on the tensor cores): `--profile-steps` steps
     each with launches counted (K5 8 a step, 12 with the canonical or
     sigma entry and exit), busy ms of one profiled step, peak GiB, the
     first step against plain at the bf16 gates; the fp8 runs' transported
     values counted for non-finite ones (0 wanted); the fp8 transport
     and its K5 gather on the card bit for bit against the plain version on
     the CPU, values past 464 and +-inf included; the twins' forward bits:
     static + fold_unsort and static + unsort_rows against static, canon
     against the plain plan with packing and the bf16 kernels off (and
     that pair's gradients at the f32 gates);
 37. the sharded modes (`phase_sharded_modes`): post-sort dynamic keys
     under head / hash TP, use_ckpt under sharding, zero padding under the
     bucket SP, on two gloo ranks sharing the card and at world 1 (NCCL);
 38. attn_impl "xla" (the JAX package's default; `phase_xla_impl`): the
     parity YAML (f32: K6 f32 / K7 v1) and hept_fast (K6 exact-bias bf16 on
     the tensor cores, K7 v1 on bf16) with "xla", `--profile-steps` steps
     each, busy ms, peak GiB, the first step against plain, and each the
     same bits as its "hybrid" twin; one step each of the models of a bare
     TransformerConfig(in_dim, coords_dim) (zero padding, "xla") and of
     ExperimentConfig() ("pallas") against plain at the f32 gates.
Before the last line: one JSON line of per-kernel numbers (K5 once per row
shape, K3 at d = 1 as K3d1, K4 with its yardsticks as extra keys; K3 / K4
with the baselines', the GNNs' and the loss options' launches at d = 12,
K3d1 and K4's `d1_launches` with theirs at d = 1; K1 / K2 with the flat
and DP phases' launches, K6 / K7 with the TP ranks', K10 with the SP
ranks'; K6 / K7 / K5p with the share_heads steps', the world-1 bucket
steps' and the bucket ranks', and the dynamic-key runs' of phases 32-34;
K6 / K7 with the sharded runs' of phase 37 and the "xla" runs' of 38;
K5g / K5gb, gather_sort's 120 B and 60 B rows, with its runs'; K5h50,
K5g2r, K5g4r and K5e96, the static family's 50 B head-broadcast, 800 /
1600 B group and 96 B entry rows, with phase 36's runs'), and the
`nvidia-smi` name/power-limit line. `--yardsticks-only [--package-root
DIR]` builds the kernels of the package in DIR (a parent tree, for an A/B
in one call), prints K3's, K4's and K5's yardsticks, K2's, K6's, K7's,
K10's and K12's device times with a digest of their output bits (K12 with
its library yardstick, its bound and its kernels' device times) as one
JSON line and stops, without a result line. The last line is
{"ok": true, "device": {...}}. Any failed check raises (exit code != 0).
Exits with code 2 and prints no result without a CUDA device or without the
`hept_tpu_torch` package beside this script.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
DEVICE = "cuda"
# the keys every kernel's entry of the JSON line has
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")
# K3 / K4 launches and CSR builds of one InfoNCE loss: per training step
# (forward and backward) and per evaluated event (forward); K3 and K4 at d = 1
# (the negative sums, their gather and their backward) counted apart too
PAIR_LAUNCHES_STEP = {"pair_gather": 3, "pair_gather_d1": 2, "pair_segment_sum": 3,
                      "pair_segment_sum_d1": 2, "anchor_csr": 1}
PAIR_LAUNCHES_EVAL = {"pair_gather": 2, "pair_gather_d1": 1, "pair_segment_sum": 1,
                      "pair_segment_sum_d1": 1, "anchor_csr": 1}
# a training step of the windowed InfoNCE with the cosine or l2_inverse
# similarity: the l2_rbf step's launches, but the similarity's backward is
# two K4 at d = 12, pair_gather's and partner_gather's
PAIR_LAUNCHES_PARTNER = {**PAIR_LAUNCHES_STEP, "pair_segment_sum": 4}
NO_PAIRS = dict.fromkeys(PAIR_LAUNCHES_STEP, 0)
# K1 / K2 on neither route: the paths that run K6 / K7 or K10
NO_K1_K2 = {"bucket_attn_fwd_tc": 0, "bucket_attn_bwd_tc": 0, "bucket_attn_fwd": 0,
            "bucket_attn_bwd": 0}
# K6 / K7 on neither route: the paths that run K1 / K2 or K10
NO_K6_K7 = {"cols_fwd_tc": 0, "cols_fwd": 0, "cols_bwd_tc": 0, "cols_bwd": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph and replayed between two events, so the host's launch overhead
    (Python, ctypes, allocation) does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# K1 / K2's per-logit work outside the tensor cores: one ex2 on the SFU (16
# a clock per SM) and FP32 instructions on the 128 lanes of an SM (K1: two
# bias adds, clamp, scale, denominator, half a bf16 pack; K2 per pass: those
# and the dl product, select, hi/lo split and packs), per pass over the logits
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9  # H100 SXM, maximum SM clock
K1_FP32_PER_LOGIT, K2_FP32_PER_LOGIT = 7, 12


def logit_floors(logits: float, fp32_per_logit: int, passes: int) -> dict:
    """Least times of the per-logit ex2 and FP32 work of `passes` passes."""
    work = passes * logits / (SM_COUNT * SM_CLOCK_HZ) * 1e3
    return {"sfu_floor_ms": work / 16, "alu_floor_ms": work * fp32_per_logit / 128}


def bound_ms(nbytes: float, flops: float, flop_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def scale(a) -> float:
    return float(a.float().abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol and math.isfinite(err)
    log(f"  {name}: {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} above tolerance {tol:.3e}")


def library_yardstick(torch, sq, sk, sv, bs: int, want) -> dict:
    """The one PyTorch call that computes a bucket forward's function up to
    one elementwise rescale, timed by CUDA graph replay on inputs prepared
    beforehand; the port never calls it. Softmax attention with scale 1 and
    its log-sum-exp (`_scaled_dot_product_efficient_attention`) over the
    buckets as (r * nb, 1, bs, E) batches of the augmented columns [q, q_hi,
    q_lo, 1, 1] and [k, 1, 1, k_hi, k_lo], zero-padded to E % 8 == 0: their
    product is the logit q.k - |q|^2/2 - |k|^2/2 (hi + lo: each f32 bias as
    two bf16 values, as K6 hi/lo carries it; in f32 the bias and 0), so the
    call returns (so / denom, log denom). Returns library_ms, its max|d|
    against `want` = the plain (denom, so), and that error over the plain
    so's scale; where the call refuses the inputs, library_ms None and why."""
    r, d, n = sq.shape
    dv, nb, dt = sv.shape[1], n // bs, sq.dtype
    width = -(-(d + 4) // 8) * 8

    def augment(x, bias_first: bool):
        xf = x.float().reshape(r, d, nb, bs)
        bias = -0.5 * (xf * xf).sum(1)  # (r, nb, bs), from the f32 values
        hi = bias.to(dt).float()
        lo = bias - hi if dt == torch.float32 else (bias - hi).to(dt).float()
        ones = torch.ones_like(bias)
        tail = (hi, lo, ones, ones) if bias_first else (ones, ones, hi, lo)
        out = torch.zeros((r, nb, bs, width), dtype=dt, device=x.device)
        out[..., :d] = xf.permute(0, 2, 3, 1).to(dt)
        out[..., d:d + 4] = torch.stack(tail, -1).to(dt)
        return out.reshape(r * nb, 1, bs, width)

    qa, ka = augment(sq, True), augment(sk, False)
    va = sv.reshape(r, dv, nb, bs).permute(0, 2, 3, 1).reshape(r * nb, 1, bs, dv).contiguous()

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qa, ka, va, None, True, 0.0, False, scale=1.0)[:2]

    try:
        out, lse = call()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return {"library_ms": None,
                "library_note": "efficient attention refused: " + str(exc).splitlines()[0][:160]}
    den = lse[..., :bs].float().exp()  # the log-sum-exp may be padded to 32 points
    so = (out.float() * den[..., None]).reshape(r, nb, bs, dv).permute(0, 3, 1, 2)
    err = max(max_err(den.reshape(r, 1, n) + 1e-20, want[0]), max_err(so.reshape(r, dv, n), want[1]))
    del out, lse, den, so
    return {"library_ms": graph_ms(call, 10), "library_max_abs_err": err,
            "library_err_over_scale": err / scale(want[1]),
            "library_call": f"_scaled_dot_product_efficient_attention {dt} (B={r * nb}, L={bs}, "
                            f"E={width}, Ev={dv}), so = out * exp(lse)"}


def log_library(row: dict) -> None:
    if row["library_ms"] is None:
        log(f"  {row['name']} library yardstick: {row['library_note']}")
    else:
        log(f"  {row['name']} library yardstick: {row['library_call']}: {row['library_ms']:.4f} "
            f"ms device, max|d| vs plain {row['library_max_abs_err']:.3e} "
            f"({row['library_err_over_scale']:.2e} of the plain so's scale)")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_batch(points: int, seed: int, block_size: int):
    """One synthetic event and its packed batch."""
    import numpy as np

    from hept_tpu_torch.data.batching import pack_events, slab_friendly_n
    from hept_tpu_torch.data.synthetic import synthetic_tracking_event

    ev = synthetic_tracking_event(np.random.default_rng(seed), n_points=points,
                                  avg_track_size=8, pairs_per_point=16)
    batch = pack_events([ev], block_size=block_size,
                        n_max=slab_friendly_n(points, block_size), window_pairs=128)
    # the pack-time layout K4 relies on: anchor-sorted, 128-pair windows
    # spanning < 128 rows, reversal-closed real pairs
    p, m, rev = batch["pairs"][0], batch["pair_mask"][0], batch["pair_rev"][0]
    w = p[0].reshape(-1, 128)
    real = m.reshape(-1, 128)
    span = np.where(real, w, w[:, :1]).max(1) - np.where(real, w, w[:, :1]).min(1)
    if not ((np.diff(p[0]) >= 0).all() and (span < 128).all()
            and (p[0, rev[m]] == p[1, m]).all()):
        raise AssertionError("packed pairs break the windowed layout")
    return ev, batch


def make_pileup_batch(points: int, seed: int, block_size: int):
    """One synthetic pileup event and its packed batch (no pairs)."""
    import numpy as np

    from hept_tpu_torch.data.batching import pack_events, slab_friendly_n
    from hept_tpu_torch.data.synthetic import synthetic_pileup_event

    ev = synthetic_pileup_event(np.random.default_rng(seed), n_points=points)
    return ev, pack_events([ev], block_size=block_size,
                           n_max=slab_friendly_n(points, block_size))


def phase_kernels(torch, batch, seed: int) -> dict:
    """K1-K4 against their plain versions at the main path's shapes."""
    from hept_tpu_torch.ops import bucket_attn_cuda as ba
    from hept_tpu_torch.ops import pair_ops as po

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, d, dv, bs = 16, 30, 24, 512  # 2 rounds x 8 heads; 24 + 6 RPE columns
    n = batch["x"].shape[1]
    nb = n // bs

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    # the main path's regime: x part O(0.3), RPE part centred per bucket
    # (kernel_center) with O(0.5) local spread
    def qk(common):
        rpe = (common + randn(r, 6, nb, bs, s=0.5)).reshape(r, 6, n)
        return torch.cat([randn(r, 24, n, s=0.3), rpe], 1).to(torch.bfloat16).contiguous()

    zero = torch.zeros((r, 6, nb, 1), device=dev)
    sq, sk = qk(zero), qk(zero)
    sv = randn(r, dv, n).to(torch.bfloat16)
    g_den = randn(r, 1, n)
    g_so = randn(r, dv, n)
    rows = []

    # K1 / K2 on the tensor-core route (bf16, bs % 16 == 0), as the main path
    assert ba.bucket_attn_route(sq.dtype, bs) == "tc"
    den_k, so_k = ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)
    den_p, so_p = ba.bucket_attn_fwd_plain(sq, sk, sv, bs)
    torch.cuda.synchronize()
    log("kernel K1 bucket_attn_fwd (tensor cores; bf16, r=16 d=30 dv=24 n=%d bs=512):" % n)
    # pt is rounded to bf16 before the value product; kernel and plain sum the
    # logits in different orders, so a rounding can flip (2^-8 relative on
    # one term of a 512-term sum)
    e_den, e_so = max_err(den_k, den_p), max_err(so_k, so_p)
    check("denom max|d|", e_den, 1e-4 * scale(den_p))
    check("so max|d|", e_so, 5e-3 * scale(so_p))
    if not all(torch.equal(a, b) for _ in range(3)
               for a, b in zip((den_k, so_k), ba.bucket_attn_fwd_cuda(sq, sk, sv, bs))):
        raise AssertionError("K1: repeated calls differ in their bits")
    log("  K1: the same bits on 4 calls")
    by = 2 * (2 * r * d * n + r * dv * n) + 4 * (r * n + r * dv * n)
    fl = 2.0 * r * n * bs * (d + dv)
    b_ms, b_by = bound_ms(by, fl, BF16_FLOP_PER_S)
    rows.append(dict(name="K1 bucket_attn_fwd", route="cuda",
                     source="hept_tpu_torch/csrc/bucket_attn.cu",
                     replaces="hept_tpu/ops/bucket_attn_pallas.py:858",
                     max_abs_err=max(e_den, e_so),
                     ms=time_ms(lambda: ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)),
                     device_ms=graph_ms(lambda: ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)),
                     plain_ms=time_ms(lambda: ba.bucket_attn_fwd_plain(sq, sk, sv, bs), 3, 1),
                     bound_ms=b_ms, bound_by=b_by,
                     **library_yardstick(torch, sq, sk, sv, bs, (den_p, so_p))))

    dq_k, dk_k, dv_k = ba.bucket_attn_bwd_cuda(sq, sk, sv, g_den, g_so, bs)
    dq_p, dk_p, dv_p = ba.bucket_attn_bwd_plain(sq, sk, sv, g_den, g_so, bs)
    torch.cuda.synchronize()
    log("kernel K2 bucket_attn_bwd (tensor cores; bf16 in/out, f32 cotangents):")
    # outputs are bf16: one rounding of slightly different f32 values can
    # differ by 1 bf16 ulp (2^-8 relative); both split dl into hi/lo bf16
    errs = []
    for nm, a, b in (("dq", dq_k, dq_p), ("dk", dk_k, dk_p), ("dv", dv_k, dv_p)):
        errs.append(max_err(a, b))
        check(f"{nm} max|d|", errs[-1], 1e-2 * scale(b))
    if not all(torch.equal(a, b) for _ in range(3) for a, b in
               zip((dq_k, dk_k, dv_k), ba.bucket_attn_bwd_cuda(sq, sk, sv, g_den, g_so, bs))):
        raise AssertionError("K2: repeated calls differ in their bits")
    log("  K2: the same bits on 4 calls")
    # the contract: K2 is the gradient of the bf16 forward -- f32 autograd of
    # the K1 math at the same bf16 values, 2e-2 x scale (as the JAX test), in
    # the regime that broke the old TPU backward: uncentred RPE rows with a
    # per-bucket common mode ~40
    common = randn(r, 6, nb, 1, s=40.0)
    cq, ck = qk(common), qk(common)
    ins = [t.float().requires_grad_(True) for t in (cq, ck, sv)]
    den_f, so_f = ba.bucket_attn_fwd_plain(*ins, bs)
    ref = torch.autograd.grad((den_f * g_den).sum() + (so_f * g_so).sum(), ins)
    del den_f, so_f, ins
    got = ba.bucket_attn_bwd_cuda(cq, ck, sv, g_den, g_so, bs)
    for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(f"{nm} max|d| vs f32 autograd of the bf16 forward (common mode 40)", max_err(a, b),
              2e-2 * scale(b))
    del ref, got, cq, ck
    by = (2 * r * d * n + r * dv * n) * 2 * 2 + 4 * (r * dv * n + r * n)
    fl = 2.0 * r * n * bs * (3 * d + 2 * dv + 2)
    b_ms, b_by = bound_ms(by, fl, BF16_FLOP_PER_S)
    rows.append(dict(name="K2 bucket_attn_bwd", route="cuda",
                     source="hept_tpu_torch/csrc/bucket_attn.cu",
                     replaces="hept_tpu/ops/bucket_attn_pallas.py:893",
                     max_abs_err=max(errs),
                     ms=time_ms(lambda: ba.bucket_attn_bwd_cuda(sq, sk, sv, g_den, g_so, bs)),
                     device_ms=graph_ms(
                         lambda: ba.bucket_attn_bwd_cuda(sq, sk, sv, g_den, g_so, bs)),
                     plain_ms=time_ms(
                         lambda: ba.bucket_attn_bwd_plain(sq, sk, sv, g_den, g_so, bs), 3, 1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del den_k, so_k, den_p, so_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p

    # the scalar route at the same shape in f32 (hept_acc with its bf16 modes
    # off): no TF32, f32 sums of 512 terms in other orders
    s32 = [t.float() for t in (sq, sk, sv)]
    assert ba.bucket_attn_route(torch.float32, bs) == "scalar"
    log("kernel K1 / K2 scalar route (f32, the same shape):")
    e32 = []
    for nm, a, b in zip(("denom", "so"), ba.bucket_attn_fwd_cuda(*s32, bs),
                        ba.bucket_attn_fwd_plain(*s32, bs)):
        e32.append(max_err(a, b))
        check(f"K1 f32 {nm} max|d|", e32[-1], 1e-4 * scale(b))
    for nm, a, b in zip(("dq", "dk", "dv"), ba.bucket_attn_bwd_cuda(*s32, g_den, g_so, bs),
                        ba.bucket_attn_bwd_plain(*s32, g_den, g_so, bs)):
        e32.append(max_err(a, b))
        check(f"K2 f32 {nm} max|d|", e32[-1], 1e-4 * scale(b))
    rows[0].update(scalar_f32_device_ms=graph_ms(lambda: ba.bucket_attn_fwd_cuda(*s32, bs), 5),
                   scalar_f32_max_abs_err=max(e32[:2]))
    rows[1].update(
        scalar_f32_device_ms=graph_ms(lambda: ba.bucket_attn_bwd_cuda(*s32, g_den, g_so, bs), 3),
        scalar_f32_max_abs_err=max(e32[2:]))
    del s32
    # the floors are estimates for this log line only: the kernels line
    # carries measured numbers and bound_ms
    for row, floors in zip(rows, (logit_floors(r * n * bs, K1_FP32_PER_LOGIT, 1),
                                  logit_floors(r * n * bs, K2_FP32_PER_LOGIT, 2))):
        log(f"  {row['name']}: tensor cores {row['device_ms']:.4f} ms device "
            f"({row['ms']:.4f} ms by events), scalar f32 route {row['scalar_f32_device_ms']:.4f} "
            f"ms device, plain {row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); per-logit floors outside the tensor cores (not in bound_ms, "
            f"at {SM_CLOCK_HZ / 1e9:.2f} GHz): ex2 {floors['sfu_floor_ms']:.4f} ms, FP32 "
            f"{floors['alu_floor_ms']:.4f} ms")
    log_library(rows[0])
    del sq, sk, sv, g_den, g_so
    torch.cuda.empty_cache()

    # K3 / K4 on the batch's anchor index, 12-wide embeddings (the loss's
    # similarity gather and its backward) and 1-wide (negative sums)
    idx = torch.as_tensor(batch["pairs"][0, 0]).to(dev).contiguous()
    mask = torch.as_tensor(batch["pair_mask"][0]).to(dev)
    e = idx.shape[0]
    errs3, errs4 = [], []
    log(f"kernel K3 pair_gather / K4 pair_segment_sum (E={e}, n={n}):")
    csr = po.anchor_csr(idx, n)
    for width in (12, 1):
        emb = randn(n, width)
        vals = (randn(e, width) * mask[:, None]).contiguous()
        errs3.append(k3_check(torch, po, emb, idx, f"d={width}"))
        ref4 = po.segment_sum_plain(vals, idx, n)
        got4 = po.segment_sum_cuda(vals, idx, n, csr)
        # index_add_ sums with atomics in another order
        for label, got in (("CSR given", got4), ("own CSR", po.segment_sum_cuda(vals, idx, n))):
            errs4.append(max_err(got, ref4))
            check(f"K4 d={width} max|d| ({label})", errs4[-1], 1e-5 * scale(ref4) + 1e-6)
        if not all(torch.equal(got4, po.segment_sum_cuda(vals, idx, n, csr)) for _ in range(3)):
            raise AssertionError(f"K4 d={width}: repeated calls differ in their bits")
        log(f"  K4 d={width}: the same bits on 4 calls")
    # K3 off the vector path: 7-wide rows of an emb 4 bytes into a larger
    # buffer, and indices out of range (NaN rows)
    flat = randn(n * 7 + 1)
    errs3.append(k3_check(torch, po, flat[1:].view(n, 7), idx, "d=7, emb at a 4-byte offset"))
    bad = idx.clone()
    bad[::97], bad[1::89] = n, -1
    errs3.append(k3_check(torch, po, randn(n, 12), bad, "d=12, indices out of range"))
    # the training loader's cached layout is sorted per block only: K4 must
    # not depend on a globally sorted index
    perm = torch.randperm(e, generator=gen, device=dev)
    ref4 = po.segment_sum_plain(vals[perm].contiguous(), idx[perm].contiguous(), n)
    errs4.append(max_err(po.segment_sum_cuda(vals[perm].contiguous(), idx[perm].contiguous(), n),
                         ref4))
    check("K4 d=1 max|d| (unsorted index)", errs4[-1], 1e-5 * scale(ref4) + 1e-6)
    k3 = k3_yardsticks(torch, po, idx, n, gen)
    for width, key in ((12, "K3"), (1, "K3d1")):
        emb = randn(n, width)
        rows.append(dict(name=f"{key} pair_gather",
                         route="cuda", source="hept_tpu_torch/csrc/pair_ops.cu",
                         replaces="hept_tpu/ops/pair_ops.py:142", max_abs_err=max(errs3),
                         ms=k3[f"kernel_d{width}_device_ms"],
                         plain_ms=time_ms(lambda emb=emb: po.gather_rows_plain(emb, idx), 20),
                         bound_ms=k3[f"kernel_d{width}_bound_ms"], bound_by="bytes",
                         library_ms=k3[f"index_select_d{width}_device_ms"],
                         events_ms=k3[f"kernel_d{width}_ms"],
                         library_events_ms=k3[f"index_select_d{width}_ms"]))
    k4 = k4_yardsticks(torch, po, idx, mask, n, gen)
    vals = (randn(e, 12) * mask[:, None]).contiguous()
    rows.append(dict(name="K4 pair_segment_sum", route="cuda",
                     source="hept_tpu_torch/csrc/pair_ops.cu",
                     replaces="hept_tpu/ops/pair_ops.py:93", max_abs_err=max(errs4),
                     ms=k4["kernel_d12_ms"],
                     plain_ms=time_ms(lambda: po.segment_sum_plain(vals, idx, n), 20),
                     bound_ms=k4["kernel_d12_bound_ms"], bound_by="bytes",
                     library_ms=k4["index_add_d12_ms"],
                     # the yardsticks' own bounds stay on their log line: the
                     # kernels line carries measured numbers and bound_ms
                     **{k: v for k, v in k4.items()
                        if k not in ("kernel_d12_ms", "index_add_d12_ms")
                        and not k.endswith("_bound_ms")}))
    for row in rows:
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {row["name"].split()[0]: row for row in rows}


def k3_check(torch, po, emb, idx, label: str) -> float:
    """K3 against its plain version, bit for bit; rows at an index outside
    [0, n) must be NaN (the plain version cannot take them). Returns the
    max|d| over the in-range rows (0)."""
    got = po.gather_rows_cuda(emb, idx)
    ok = (idx >= 0) & (idx < emb.shape[0])
    want = po.gather_rows_plain(emb, idx.clamp(0, emb.shape[0] - 1))
    same = torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
    nan = bool(torch.isnan(got[~ok]).all())
    log(f"  K3 {label}: {'bit-equal' if same else 'DIFFERS'} to plain over {int(ok.sum())} "
        f"pairs" + (f", {int((~ok).sum())} out of range {'NaN' if nan else 'NOT NaN'}"
                    if not bool(ok.all()) else ""))
    if not (same and nan):
        raise AssertionError(f"K3 {label}: not an exact copy")
    return max_err(got[ok], want[ok])


def k3_yardsticks(torch, po, idx, n: int, gen) -> dict:
    """K3 on the batch's anchor index at d = 12 and d = 1 (the loss's
    similarity gather; the negative sums' and the segment sum's backward),
    each beside its bound (each index and output row once, emb once) and
    `index_select`: `<name>_ms` by CUDA events around 50 calls in a row,
    `<name>_device_ms` by CUDA graph replay, and a digest of the kernel's
    output bits."""
    e = idx.shape[0]
    idx64 = idx.long()
    out = {}
    for d in (12, 1):
        emb = torch.randn((n, d), generator=gen, device=idx.device)
        out[f"kernel_d{d}_bits"] = bits_digest([po.gather_rows_cuda(emb, idx)])
        out[f"kernel_d{d}_bound_ms"] = bound_ms(4.0 * (n * d + e + e * d), 0.0, F32_FLOP_PER_S)[0]
        for name, fn in ((f"kernel_d{d}", lambda emb=emb: po.gather_rows_cuda(emb, idx)),
                         (f"index_select_d{d}", lambda emb=emb: emb.index_select(0, idx64))):
            out[f"{name}_ms"] = time_ms(fn, 50)
            out[f"{name}_device_ms"] = graph_ms(fn)
    log(f"  K3 (E={e}, n={n}; device ms by graph replay, in a row of calls): d=12 "
        f"{out['kernel_d12_device_ms']:.4f} ({out['kernel_d12_ms']:.4f}), bound "
        f"{out['kernel_d12_bound_ms']:.4f}, index_select {out['index_select_d12_device_ms']:.4f}; "
        f"d=1 {out['kernel_d1_device_ms']:.4f} ({out['kernel_d1_ms']:.4f}), bound "
        f"{out['kernel_d1_bound_ms']:.4f}, index_select {out['index_select_d1_device_ms']:.4f}")
    return out


def k4_yardsticks(torch, po, idx, mask, n: int, gen) -> dict:
    """K4's times on the batch's anchor index, each beside its bound: the
    kernel with the CSR given at d = 12 and d = 1 and `index_add_` at each
    width; the CSR build alone; a whole call that builds its own CSR; the
    step's K4 cost (one build, one d = 12 and two d = 1 calls) against three
    `index_add_` calls. Each as `<name>_ms` (CUDA events around 50 calls in a
    row: the larger of device and host time) and `<name>_device_ms` (CUDA
    graph replay). On a tree without `anchor_csr` (an A/B parent) every call
    sorts, and the step is three whole calls."""
    dev, e = idx.device, idx.shape[0]
    idx64 = idx.long()
    vals = {d: (torch.randn((e, d), generator=gen, device=dev) * mask[:, None]).contiguous()
            for d in (12, 1)}
    zeros = {d: torch.zeros((n, d), device=dev) for d in (12, 1)}
    make_csr = getattr(po, "anchor_csr", None)
    csr = None if make_csr is None else make_csr(idx, n)

    def step():
        c = None if make_csr is None else make_csr(idx, n)
        for d in (12, 1, 1):
            po.segment_sum_cuda(vals[d], idx, n, *(() if c is None else (c,)))

    def library_step():
        for d in (12, 1, 1):
            zeros[d].clone().index_add_(0, idx64, vals[d])

    fns = {"step": step, "library_step": library_step,
           "csr_build": None if csr is None else (lambda: make_csr(idx, n))}
    out = {}
    for d in (12, 1):
        fns[f"kernel_d{d}"] = None if csr is None else (
            lambda d=d: po.segment_sum_cuda(vals[d], idx, n, csr))
        fns[f"call_d{d}"] = lambda d=d: po.segment_sum_cuda(vals[d], idx, n)
        fns[f"index_add_d{d}"] = lambda d=d: zeros[d].clone().index_add_(0, idx64, vals[d])
        # each value row and order entry read once, each output row and row
        # pointer written once
        out[f"kernel_d{d}_bound_ms"] = bound_ms(4.0 * (e + n) * (d + 1), 0.0, F32_FLOP_PER_S)[0]
    # the build reads the index and writes order and rowptr once
    out["csr_build_bound_ms"] = bound_ms(4.0 * (2 * e + n + 1), 0.0, F32_FLOP_PER_S)[0]
    out["step_bound_ms"] = (out["csr_build_bound_ms"] + out["kernel_d12_bound_ms"]
                            + 2 * out["kernel_d1_bound_ms"])
    for name, fn in fns.items():
        out[f"{name}_ms"] = None if fn is None else time_ms(fn, 50)
        out[f"{name}_device_ms"] = None if fn is None else graph_ms(fn)

    def both(name):
        if out[f"{name}_ms"] is None:
            return "-"
        return f"{out[f'{name}_ms']:.4f} ({out[f'{name}_device_ms']:.4f})"

    log(f"  K4 (E={e}, n={n}; ms in a row of calls (device ms)): kernel with CSR d=12 "
        f"{both('kernel_d12')} (bound {out['kernel_d12_bound_ms']:.4f}, index_add_ "
        f"{both('index_add_d12')}), d=1 {both('kernel_d1')} (bound "
        f"{out['kernel_d1_bound_ms']:.4f}, index_add_ {both('index_add_d1')}); whole call "
        f"d=12 {both('call_d12')}, d=1 {both('call_d1')}; CSR build {both('csr_build')} (bound "
        f"{out['csr_build_bound_ms']:.4f}); step's K4 {both('step')} (bound "
        f"{out['step_bound_ms']:.4f}) vs 3 index_add_ {both('library_step')}")
    return out


# K5 at the rows the paths move: (label, dtype, R, S, n, W, who runs it)
K5_SHAPES = (
    ("bf16 400 B", "bfloat16", 2, 2, 60416, 200, "hept_acc, hept_fast, eval"),
    ("f32 800 B", "float32", 2, 2, 60416, 200, "hept_acc with its bf16 modes off"),
    ("f32 100 B", "float32", 24, 24, 60000, 25, "parity step's unsort"),
    ("f32 120 B", "float32", 24, 8, 60000, 30, "hept_attention_core's q/k transport"),
    ("f32 96 B", "float32", 24, 8, 60000, 24, "hept_attention_core's v transport"),
    ("f32 120 B gather_sort", "float32", 24, 1, 60000, 30,
     "gather_sort's [x | coords] copies, per-head keys (a broadcast source)"),
    ("bf16 60 B gather_sort", "bfloat16", 24, 1, 60000, 30,
     "gather_sort's [x | coords] copies under sort_pack"),
    ("bf16 50 B head-broadcast", "bfloat16", 24, 24, 60000, 25,
     "the static family's head-broadcast unsort under unsort_pack or fp8 (bs 100)"),
    ("bf16 800 B groups g=2", "bfloat16", 2, 2, 30208, 400,
     "transport groups' unsort, g = 2 (nh2r8bs512cv2rg2)"),
    ("bf16 1600 B groups g=4", "bfloat16", 2, 2, 15104, 800,
     "transport groups' unsort, g = 4 (nh2r8bs512cv2rg4)"),
    ("f32 96 B entry", "float32", 1, 1, 60000, 24,
     "the canonical / sigma entry of the residual stream"),
)


def k5_yardsticks(torch, rg, gen) -> list[dict]:
    """K5 at each of K5_SHAPES: bit-equal to its plain version, then the
    kernel, the plain version and `index_select` on the flat view timed (and
    kernel and index_select by CUDA graph replay, `*device_ms`), beside the
    bound (each source row read once, each index read once, each output row
    written once)."""
    dev = gen.device
    out = []
    for label, dtype, r, s, n, w, who in K5_SHAPES:
        el = 2 if dtype == "bfloat16" else 4
        bits = torch.int16 if el == 2 else torch.int32
        src = torch.randint(-2**15, 2**15, (s, n, w), generator=gen, device=dev,
                            dtype=torch.int32).to(bits).view(getattr(torch, dtype))
        idx = torch.stack([torch.randperm(n, generator=gen, device=dev) for _ in range(r)])
        got, want = rg.row_gather_cuda(src, idx), rg.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError(f"K5 {label}: kernel and plain version differ in "
                                 f"{int((got.view(bits) != want.view(bits)).sum())} elements")
        flat = src.reshape(s * n, w)
        flat_idx = (idx + (torch.arange(r, device=dev)[:, None] % s) * n).reshape(-1)
        rb = w * el
        row = dict(label=label, R=r, S=s, n=n, row_bytes=rb, runs_in=who, max_abs_err=0.0,
                   ms=time_ms(lambda: rg.row_gather_cuda(src, idx), 50),
                   plain_ms=time_ms(lambda: rg.row_gather_plain(src, idx), 20),
                   library_ms=time_ms(lambda: flat.index_select(0, flat_idx), 50),
                   device_ms=graph_ms(lambda: rg.row_gather_cuda(src, idx)),
                   library_device_ms=graph_ms(lambda: flat.index_select(0, flat_idx)),
                   bound_ms=bound_ms(1.0 * s * n * rb + r * n * (rb + 8.0), 0.0,
                                     F32_FLOP_PER_S)[0], bound_by="bytes")
        log(f"  K5 {label} (R={r} S={s} n={n}; {who}): bit-equal; kernel {row['ms']:.4f} ms "
            f"(device {row['device_ms']:.4f}), index_select {row['library_ms']:.4f} ms (device "
            f"{row['library_device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms")
        out.append(row)
        del src, idx, got, want, flat, flat_idx
    return out


def phase_row_gather(torch, n: int, seed: int) -> dict:
    """K5 against its plain version exactly: on the main path's rows (bf16 and
    f32, the forward's and the backward's index, a broadcast source, a
    ragged n), then at every shape of K5_SHAPES, timed. One kernel row per
    shape, keyed K5 (the main path's bf16 rows), K5f32, K5p, K5q, K5v, K5g,
    K5gb, K5h50, K5g2r, K5g4r, K5e96."""
    from hept_tpu_torch.ops import row_gather as rg

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, w = 2, 8 * (24 + 1)  # rounds per layer; h * (dv + 1) features per row

    def perms(count, size):
        return torch.stack([torch.randperm(size, generator=gen, device=dev)
                            for _ in range(count)])

    src32 = torch.randn((c, n, w), generator=gen, device=dev)
    src16 = src32.to(torch.bfloat16)
    plan_src = perms(c, n)  # sorted slot -> row: the backward's index
    plan_inv = torch.argsort(plan_src, dim=-1)  # row -> sorted slot: the forward's
    n_rag = n - 37
    rag16 = torch.randn((c, n_rag, w), generator=gen, device=dev).to(torch.bfloat16)
    cases = [("bf16 rows, forward index (inv)", src16, plan_inv),
             ("bf16 rows, backward index (src)", src16, plan_src),
             ("f32 rows, forward index (inv)", src32, plan_inv),
             ("f32 rows, backward index (src)", src32, plan_src),
             ("bf16 broadcast source S=1, R=2", src16[:1], plan_inv),
             (f"bf16 ragged n={n_rag}", rag16, perms(c, n_rag))]
    log(f"kernel K5 row_gather (R=S={c}, n={n}, W={w}; exact copies):")
    for name, s, i in cases:
        k, p = rg.row_gather_cuda(s, i), rg.row_gather_plain(s, i)
        torch.cuda.synchronize()
        bits = torch.int16 if s.element_size() == 2 else torch.int32
        if not torch.equal(k.view(bits), p.view(bits)):
            raise AssertionError(f"K5 {name}: kernel and plain version differ in "
                                 f"{int((k.view(bits) != p.view(bits)).sum())} elements")
        check(f"{name} max|d|", max_err(k, p), 0.0)
    del src32, src16, plan_src, plan_inv, rag16, cases
    torch.cuda.empty_cache()
    rows = {}
    for key, row in zip(("K5", "K5f32", "K5p", "K5q", "K5v", "K5g", "K5gb", "K5h50", "K5g2r",
                         "K5g4r", "K5e96"),
                        k5_yardsticks(torch, rg, gen)):
        rows[key] = dict(row, name=f"K5 row_gather ({row.pop('label')} rows)", route="cuda",
                         source="hept_tpu_torch/csrc/row_gather.cu",
                         replaces="hept_tpu/ops/gather_pallas.py:208")
    return rows


def same_bits(torch, label: str, first, call) -> None:
    """Three more calls give `first`'s bits exactly."""
    if not all(torch.equal(a, b) for _ in range(3) for a, b in zip(first, call())):
        raise AssertionError(f"{label}: repeated calls differ in their bits")
    log(f"  {label}: the same bits on 4 calls")


def phase_cols_kernels(torch, seed: int, d: int = 30) -> dict:
    """K6/K7 against their plain versions at d = 24 + coords_dim columns (30
    tracking, 28 pileup): the parity profile's shapes in f32 (r = 3 hashes x
    8 heads), hept_fast's in bf16 (r = 2 x 8), and a ragged bucket count;
    each kernel on its route (tensor cores for bf16 K6 and K7 v2, FP32 FMAs
    for f32), the same bits on 4 calls, timed by CUDA graph replay; K6's
    library yardstick. At d = 30 also K6's hi/lo mode and K7 v1 on bf16 (the
    slab kernels K8 / K9); at 28 the modes the pileup paths run (rows
    K6d28 / K7d28)."""
    from hept_tpu_torch.ops import bucket_attn_cuda as ba

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dv, bs = 24, 100
    full, tag = d == 30, "" if d == 30 else f"d{d}"
    wide = f"d={d}" if full else f"d={d}, pileup"

    def inputs(r, n, dtype, common=0.0):
        """q/k: 24 projection rows O(0.5) and d - 24 RPE rows with a
        per-bucket common mode shared by q and k; values, cotangents."""
        nb = n // bs
        shared = torch.randn((r, d - 24, nb, 1), generator=gen, device=dev) * common

        def qk():
            x = torch.randn((r, d, nb, bs), generator=gen, device=dev) * 0.5
            x[:, 24:] += shared
            return x.reshape(r, d, n).to(dtype).contiguous()

        rn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        return qk(), qk(), rn(r, dv, n).to(dtype), rn(r, 1, n), rn(r, dv, n)

    def compare(label, got, want, tols):
        errs = []
        for nm, a, b, tol in zip(("denom", "so") if len(got) == 2 else ("dq", "dk", "dv"),
                                 got, want, tols):
            errs.append(max_err(a, b))
            check(f"{label} {nm} max|d|", errs[-1], tol * scale(b))
        return max(errs)

    def bounds(r, n, nbytes_el, fwd: bool, flop_rate):
        nb = n // bs
        if fwd:
            by = nbytes_el * r * n * (2 * d + dv) + 4 * r * n * (dv + 1)
            fl = 2.0 * r * nb * bs * bs * (d + dv)
        else:
            by = 2 * nbytes_el * r * n * (2 * d + dv) + 4 * r * n * (dv + 1)
            fl = 2.0 * r * nb * bs * bs * (3 * d + 2 * dv)
        return bound_ms(by, fl, flop_rate)

    def k6(label, sq, sk, sv, hilo, tols):
        """K6 on the route its inputs take (one launch on that route's
        counter), against its plain version, and the same bits on 4 calls;
        returns its error and its plain output."""
        name = "cols_fwd_tc" if ba.cols_fwd_route(sq.dtype, bs) == "tc" else "cols_fwd"
        before = dict(ba.LAUNCHES)
        got = ba.cols_fwd_cuda(sq, sk, sv, bs, hilo)
        delta = {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]}
        if delta != {name: 1}:
            raise AssertionError(f"{label}: launched {delta}, want {{{name!r}: 1}}")
        want = ba.cols_fwd_plain(sq, sk, sv, bs, hilo)
        err = compare(label, got, want, tols)
        same_bits(torch, label, got, lambda: ba.cols_fwd_cuda(sq, sk, sv, bs, hilo))
        return err, want

    rows, n = {}, 60000
    k6_key, k7_key = "K6" + tag, "K7" + tag
    # parity shapes, f32: FP32-FMA peak bounds (no TF32, no tensor cores)
    r = 24
    sq, sk, sv, gden, gso = inputs(r, n, torch.float32, common=2.0)
    log(f"kernel K6 cols_fwd / K7 cols_bwd (parity: f32, r={r} d={d} dv={dv} n={n} bs={bs}):")
    # K6 on FP32 FMAs (cols_fwd_tiled_kernel, 2 x 4 register tiles); f32 sums
    # of 100 terms in other orders: ~1e-6 relative per output, the max over
    # 1.4M outputs held at 1e-4 x scale
    assert ba.cols_fwd_route(torch.float32, bs) == "scalar"
    e6, want6 = k6(f"K6 f32 {wide}", sq, sk, sv, False, (1e-4, 1e-4))
    lib6 = library_yardstick(torch, sq, sk, sv, bs, want6)
    del want6
    # K7 v1 runs on FP32 FMAs (cols_bwd_tiled_kernel, one pass per bucket)
    assert ba.cols_bwd_route(torch.float32, bs, False) == "scalar"
    e7 = compare(f"K7 v1 f32 {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False),
                 ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, False), (1e-4,) * 3)
    same_bits(torch, f"K7 v1 {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False),
              lambda: ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False))
    for key, name, fwd, err, kern, plain in (
            (k6_key, "K6 cols_fwd", True, e6, lambda: ba.cols_fwd_cuda(sq, sk, sv, bs),
             lambda: ba.cols_fwd_plain(sq, sk, sv, bs)),
            (k7_key, "K7 cols_bwd", False, e7,
             lambda: ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False),
             lambda: ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, False))):
        b_ms, b_by = bounds(r, n, 4, fwd, F32_FLOP_PER_S)
        rows[key] = dict(name=name if full else f"{name} ({wide})", route="cuda",
                         source="hept_tpu_torch/csrc/bucket_attn.cu",
                         replaces=("hept_tpu/ops/bucket_attn_pallas.py:1196" if fwd else
                                   "hept_tpu/ops/bucket_attn_pallas.py:1273"),
                         max_abs_err=err, ms=time_ms(kern), device_ms=graph_ms(kern, 5),
                         plain_ms=time_ms(plain, 3, 1), bound_ms=b_ms, bound_by=b_by,
                         **(lib6 if fwd else {"library_ms": None}))
    rows[k6_key]["routes"] = (
        "f32 (parity): FP32 FMAs, cols_fwd_tiled_kernel, counter cols_fwd; bf16 (hept_fast"
        + (" / hept_turbo, exact bias; slab = K8, hi/lo bias" if full else ", exact bias")
        + "): tensor cores, tc_cols_fwd_kernel, counter cols_fwd_tc")
    rows[k7_key]["routes"] = (
        "v1 (f32, parity" + ("; and v1 on bf16 = K9" if full else "")
        + "): FP32 FMAs, cols_bwd_tiled_kernel, counter cols_bwd; v2 (bf16, hept_fast"
        + (" / hept_turbo" if full else "") + "): tensor cores, tc_cols_bwd_kernel, counter "
        "cols_bwd_tc")
    del sq, sk, sv, gden, gso
    torch.cuda.empty_cache()

    # hept_fast shapes, bf16: K6 exact bias (and at d = 30 hi/lo) and K7 v2
    # (and at d = 30 v1 upcast)
    r = 16
    sq, sk, sv, gden, gso = inputs(r, n, torch.bfloat16)
    log(f"kernel K6 / K7 (hept_fast: bf16, r={r}, {wide}, centred RPE rows):")
    extra = {}
    # K6 on the tensor cores (buckets padded to 112)
    assert ba.cols_fwd_route(torch.bfloat16, bs) == "tc"
    for hilo in (False, True) if full else (False,):
        label = "K6 bf16 " + ("hi/lo bias" if hilo else "exact bias")
        # pt is rounded to bf16 before the value product: a rounding can flip
        err, want = k6(f"{label} {wide}", sq, sk, sv, hilo, (1e-4, 5e-3))
        kern = (lambda hilo=hilo: ba.cols_fwd_cuda(sq, sk, sv, bs, hilo))
        extra[label] = (err, time_ms(kern), graph_ms(kern, 10),
                        time_ms(lambda: ba.cols_fwd_plain(sq, sk, sv, bs, hilo), 3, 1),
                        bounds(r, n, 2, True, BF16_FLOP_PER_S))
        if hilo == full:  # at 30 the call's augmented columns carry hi + lo bf16
            lib6 = library_yardstick(torch, sq, sk, sv, bs, want)
        del want
    # K7 v2 on the tensor cores (buckets padded to 112), v1 upcast on FP32 FMAs
    assert ba.cols_bwd_route(torch.bfloat16, bs, True) == "tc"
    for v2 in (True, False) if full else (True,):
        label = "K7 bf16 " + ("v2" if v2 else "v1 (upcast)")
        # bf16 outputs: one rounding of slightly different f32 values
        err = compare(f"{label} {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2),
                      ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, v2), (1e-2,) * 3)
        same_bits(torch, f"{label} {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2),
                  lambda v2=v2: ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2))
        kern = (lambda v2=v2: ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2))
        extra[label] = (err, time_ms(kern), graph_ms(kern, 5),
                        time_ms(lambda: ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, v2), 3, 1),
                        bounds(r, n, 2, False, BF16_FLOP_PER_S if v2 else F32_FLOP_PER_S))
    # the contract: K7 v2 is the gradient of the bf16 forward, held against
    # f32 autograd of the K6 math at the same bf16 values (2e-2 x scale), with
    # uncentred RPE rows (per-bucket common mode ~40), on the tensor cores
    cq, ck, _, _, _ = inputs(r, n, torch.bfloat16, common=40.0)
    ins = [t.float().requires_grad_(True) for t in (cq, ck, sv)]
    den_f, so_f = ba.cols_fwd_plain(*ins, bs)
    ref = torch.autograd.grad((den_f * gden).sum() + (so_f * gso).sum(), ins)
    # K6 on the tensor cores at the same values against that f32 forward: the
    # biases enter in f32, so the O(1) logits survive the common mode
    got = ba.cols_fwd_cuda(cq, ck, sv, bs)
    for nm, a, b in zip(("denom", "so"), got, (den_f, so_f)):
        check(f"K6 bf16 {nm} max|d| vs the f32 forward of the bf16 values (common mode 40, "
              f"{wide})", max_err(a, b), 2e-2 * scale(b))
    del den_f, so_f, ins, got
    before = ba.LAUNCHES["cols_bwd_tc"]
    got = ba.cols_bwd_cuda(cq, ck, sv, gden, gso, bs, True)
    assert ba.LAUNCHES["cols_bwd_tc"] == before + 1
    for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(f"K7 v2 {nm} max|d| vs f32 autograd of the bf16 forward (common mode 40, "
              f"{wide})", max_err(a, b), 2e-2 * scale(b))
    del ref, got, cq, ck, sq, sk, sv, gden, gso
    torch.cuda.empty_cache()

    # a ragged bucket count: 601 buckets (K6: CTAs of two, the last one
    # alone); the last bucket ends at n, where K7 v2's padded tiles stop
    n_rag = 60100
    sq, sk, sv, gden, gso = inputs(4, n_rag, torch.float32, common=2.0)
    log(f"kernel K6 / K7 (ragged: f32 and bf16, r=4, n={n_rag}, 601 buckets, {wide}):")
    k6(f"K6 f32 ragged {wide}", sq, sk, sv, False, (1e-4, 1e-4))
    compare(f"K7 v1 ragged {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False),
            ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, False), (1e-4,) * 3)
    sq, sk, sv = (t.to(torch.bfloat16) for t in (sq, sk, sv))
    k6(f"K6 bf16 ragged {wide}", sq, sk, sv, False, (1e-4, 5e-3))
    compare(f"K7 v2 ragged {wide}", ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, True),
            ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, True), (1e-2,) * 3)
    if full:
        # hi/lo on rows centred per bucket, as kernel_center feeds the bf16
        # paths: on uncentred rows each bias's lo half is a bf16 rounding of
        # an f32 |x|^2 whose summation order differs from torch's, and flips
        # one bf16 ulp of lo (~1e-4 relative in a denominator) in kernel and
        # first-cut kernel alike
        sq, sk, sv, _, _ = inputs(4, n_rag, torch.bfloat16)
        k6("K6 bf16 ragged hi/lo (centred rows)", sq, sk, sv, True, (1e-4, 5e-3))
    del sq, sk, sv, gden, gso
    torch.cuda.empty_cache()
    for key in (k6_key, k7_key):
        row = rows[key]
        log(f"  {row['name']} (parity, f32): kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} "
            f"ms device), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, operations at the FP32 peak {F32_FLOP_PER_S / 1e12:.0f} "
            "TFLOP/s)")
    log_library(rows[k6_key])
    for label, (_, ms, dev_ms, plain_ms, (b_ms, b_by)) in extra.items():
        log(f"  {label} (hept_fast, {wide}): kernel {ms:.4f} ms ({dev_ms:.4f} ms device), "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; operations at the bf16 "
            "peak, K7 v1's at the FP32 peak)")
    # the tensor-core routes' own figures beside the f32 routes' in the K6
    # and K7 rows
    for key, label, pre in ((k6_key, "K6 bf16 exact bias", "bf16_tc_"),
                            (k7_key, "K7 bf16 v2", "v2_tc_")):
        err, ms, dev_ms, plain_ms, (b_ms, b_by) = extra[label]
        rows[key].update({pre + "max_abs_err": err, pre + "ms": ms, pre + "device_ms": dev_ms,
                          pre + "plain_ms": plain_ms, pre + "bound_ms": b_ms,
                          pre + "bound_by": b_by})
    rows[k6_key].update({"bf16_tc_" + k: v for k, v in lib6.items()})
    if not full:
        log_library(dict(lib6, name=f"K6 bf16 exact bias ({wide})"))
        return rows
    # the slab kernels K8 / K9 of `attn_impl: slab` run K6 hi/lo and K7 v1
    # (the TPU's K9 upcasts its bf16 operands): their figures at hept_fast's
    # shapes, where the slab phase runs them
    for key, name, label, src_line in (
            ("K8", "K8 slab_fwd", "K6 bf16 hi/lo bias", "973"),
            ("K9", "K9 slab_bwd", "K7 bf16 v1 (upcast)", "1023")):
        err, ms, dev_ms, plain_ms, (b_ms, b_by) = extra[label]
        rows[key] = dict(name=name, route="cuda", source="hept_tpu_torch/csrc/bucket_attn.cu",
                         replaces=f"hept_tpu/ops/bucket_attn_pallas.py:{src_line}",
                         ported_by=("K6 hi/lo bias, tensor cores (tc_cols_fwd_kernel)"
                                    if key == "K8" else "K7 v1"),
                         max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         **(lib6 if key == "K8" else {"library_ms": None}))
    log_library(rows["K8"])
    return rows


def loss_and_grads(torch, model, loss_fn, batch, **forward_kw):
    """Loss and parameter gradients of one event's batch, no dropout;
    `forward_kw` go to the model's forward."""
    model.zero_grad(set_to_none=True)
    out = model(batch["x"][0], batch["coords"][0], batch["valid"][0], **forward_kw)[None]
    if out.shape != (1, batch["x"].shape[1], model.out_width) or not torch.isfinite(out).all():
        raise AssertionError(f"model output {tuple(out.shape)} not finite / wrong shape")
    loss = loss_fn(out, batch)
    loss.backward()
    # a parameter off the loss's path (reformer's w_k: q = k) has no gradient
    return float(loss.detach()), {k: torch.zeros_like(p) if p.grad is None else
                                  p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_eval(torch, trainer, model, cfg, event, batch, zero_counts, read_counts) -> None:
    """`evaluate` on one full-width event: timed, launches counted, metrics
    in [0, 1], and against the same evaluation under `plain_reference()`."""
    from hept_tpu_torch.data.datasets import SplitDataset
    from hept_tpu_torch.ops.dispatch import plain_reference
    from hept_tpu_torch.train.metrics import tracking_metrics_batch

    block_size = cfg.model_kwargs["block_size"]
    n_max = batch["x"].shape[1]
    ds = SplitDataset(train=[], valid=[], test=[event], in_dim=event.x.shape[1],
                      coords_dim=event.coords.shape[1])
    t0 = time.perf_counter()
    trainer.evaluate(cfg, model, ds, "test", block_size, n_max)  # packs and caches the split
    log(f"phase eval: first call (packs the event) {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.evaluate(cfg, model, ds, "test", block_size, n_max)  # ends in a host read
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"bucket_attn_fwd_tc": 4, "bucket_attn_bwd_tc": 0, "bucket_attn_fwd": 0,
            "bucket_attn_bwd": 0, **NO_K6_K7, "row_gather": 4, **PAIR_LAUNCHES_EVAL}
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"eval of one event launched {k} {launches[k]}x, want {v}")
    bad = {k: v for k, v in res.items()
           if not math.isfinite(v) or (k != "loss" and not 0.0 <= v <= 1.0)}
    if bad:
        raise AssertionError(f"eval metrics out of range: {bad}")
    with torch.inference_mode():
        out = trainer.model_apply(model, batch)
        args = (out, batch["cluster_ids"], batch["recons"], batch["pts"], batch["valid"])
        tracking_metrics_batch(*args)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tm = tracking_metrics_batch(*args)
        torch.cuda.synchronize()
        metrics_ms = (time.perf_counter() - t0) * 1e3
    del out, tm, args
    log(f"phase eval: evaluate() of one {event.n}-point event {eval_ms:.1f} ms, of which "
        f"the retrieval metrics (kNN, 3 thresholds) {metrics_ms:.1f} ms "
        f"({100 * metrics_ms / eval_ms:.1f} %); peak memory {peak:.2f} GiB; "
        f"launches {launches}")
    log("  " + " ".join(f"{k}={v:.6f}" for k, v in res.items()))
    with plain_reference():
        plain = trainer.evaluate(cfg, model, ds, "test", block_size, n_max)
    log("  plain: " + " ".join(f"{k}={v:.6f}" for k, v in plain.items()))
    # K1 rounds pt to bf16 where the plain version sums in another order, so
    # a few of the ~60k points' 20-neighbour lists can flip
    check("eval loss |d| (kernels vs plain)", abs(res["loss"] - plain["loss"]),
          1e-3 * abs(plain["loss"]))
    worst = max((k for k in res if k != "loss"), key=lambda k: abs(res[k] - plain[k]))
    check(f"eval metrics max|d| (kernels vs plain, worst {worst})",
          abs(res[worst] - plain[worst]), 5e-3)


def phase_trainer(torch, trainer, points: int, seed: int, task: str = "tracking",
                  profile: str = "hept_acc", config_path=None) -> None:
    """`run_one_seed`, one epoch on three synthetic events of the task: a
    checkpoint is written, restored into a fresh model and re-evaluated to
    the in-loop best test metrics. `config_path` (a YAML, as the CLI's -c
    takes it) replaces the profile; its events are then those of its own
    dataset's generator."""
    from hept_tpu_torch.data.datasets import make_synthetic_pileup, make_synthetic_tracking
    from hept_tpu_torch.train.config import load_config, profile_config
    from hept_tpu_torch.train.state import CheckpointManager

    t0 = time.perf_counter()
    if task == "pileup":
        ds = make_synthetic_pileup(n_events=3, n_points=points, seed=seed)
    elif config_path is not None:
        ds = make_synthetic_tracking(n_events=3, n_points=points, seed=seed)
    else:
        ds = make_synthetic_tracking(n_events=3, n_points=points, seed=seed, avg_track_size=8,
                                     pairs_per_point=16)
    if config_path is not None:
        profile = Path(config_path).stem
    label = "trainer" if task == "tracking" and config_path is None else \
        f"{task} trainer ({profile})"
    log(f"phase {label}: 3 synthetic events ({len(ds.train)} train, {len(ds.valid)} valid, "
        f"{len(ds.test)} test; {time.perf_counter() - t0:.1f} s)")
    lines = []

    def run_log(*a):
        lines.append(" ".join(str(x) for x in a))
        log("  " + lines[-1])

    with tempfile.TemporaryDirectory() as tmp:
        overrides = dict(task=task, device=DEVICE, num_epochs=1, log_dir=tmp, seed=seed)
        cfg = load_config(config_path, **overrides) if config_path is not None else \
            profile_config(profile, **overrides)
        t0 = time.perf_counter()
        res = trainer.run_one_seed(cfg, ds, log=run_log)
        secs = time.perf_counter() - t0
        (run_dir,) = Path(tmp).iterdir()
        step = CheckpointManager(run_dir / "ckpt").latest_step()
        recs = [json.loads(x) for x in (run_dir / "scalars.jsonl").read_text().splitlines()]
    if step is None:
        raise AssertionError("run_one_seed wrote no checkpoint")
    in_loop = [r for r in recs if "test/loss" in r][-1]
    if any("WARNING" in x for x in lines):
        raise AssertionError("run_one_seed warned about its re-eval")
    diffs = {k: abs(v - in_loop[f"test/{k}"]) for k, v in res.items()}
    log(f"phase {label}: 1 epoch in {secs:.1f} s; checkpoint at step {step}; restored re-eval "
        + " ".join(f"{k}={v:.6f}" for k, v in res.items()))
    if cfg.main_metric not in res:
        raise AssertionError(f"the restored re-eval has no {cfg.main_metric}: {res}")
    check("re-eval of the restored checkpoint vs in-loop best test, max|d|",
          max(diffs.values()), 1e-6)


def compare_first_step(torch, label: str, cfg, model, loss_fn, batch) -> None:
    """The step's loss and gradients, dropout off, with kernels and under
    `plain_reference()`, held at the profile's levels: f32 (parity) loss
    1e-4 relative and every parameter gradient 1e-3 of its scale, on the
    kernel run's permutations; bf16 loss 1e-3 relative and the whole gradient
    1e-2 relative L2."""
    from hept_tpu_torch.ops.dispatch import plain_reference

    f32 = not cfg.model_kwargs.get("kernel_bf16", False)
    # the parity run and the LSH baselines sort by keys computed from the
    # previous layer's output: the plain run takes the kernel run's
    # permutations, so a near-tie flipped by f32 rounding cannot move a
    # point's bucket. DGCNN and GravNet pick neighbours in a learned space:
    # both runs take those of a forward before them (an imposed neighbour's
    # distance is computed by another expression than the kNN's, and
    # GravNet's gradient flows through it)
    kw_k, kw_p = {}, {}
    if cfg.model_name.startswith("gnn_"):
        nbrs = []
        with torch.no_grad():
            model(batch["x"][0], batch["coords"][0], batch["valid"][0], record_nbrs=nbrs)
        kw_k = kw_p = {"nbrs": nbrs} if nbrs else {}
    elif cfg.model_kwargs.get("static_keys") is None:
        perms = []
        kw_k, kw_p = {"record_perms": perms}, {"perms": perms}
    loss_k, grads_k = loss_and_grads(torch, model, loss_fn, batch, **kw_k)
    if kw_p.get("perms") == []:  # no layer sorted by keys
        kw_p = {}
    with plain_reference():
        loss_p, grads_p = loss_and_grads(torch, model, loss_fn, batch, **kw_p)
    log(f"phase {label} compare: loss kernels {loss_k:.6f} plain {loss_p:.6f}")
    if f32:
        check(f"{label} loss |d| / |loss|", abs(loss_k - loss_p) / abs(loss_p), 1e-4)
        floor = 1e-3 * max(scale(g) for g in grads_p.values())
        ratios = {k: max_err(grads_k[k], grads_p[k]) / max(scale(grads_p[k]), floor)
                  for k in grads_p}
        worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
        log("  per tensor, max|d| / max(max|plain|, 1e-3 max over tensors), largest: "
            + ", ".join(f"{k} {ratios[k]:.3e}" for k in worst))
        check(f"{label}: all {len(ratios)} parameter gradients, worst {worst[0]}",
              ratios[worst[0]], 1e-3)
    else:
        check(f"{label} loss |d| / |loss|", abs(loss_k - loss_p) / abs(loss_p), 1e-3)
        diff2 = sum(float((grads_k[k] - grads_p[k]).double().pow(2).sum()) for k in grads_p)
        norm2 = sum(float(grads_p[k].double().pow(2).sum()) for k in grads_p)
        check(f"{label} gradient, |g_kernels - g_plain| / |g_plain| over all parameters",
              math.sqrt(diff2 / norm2), 1e-2)


def timed_steps(torch, trainer, model, opt, loss_fn, batch, gen, steps: int, label: str,
                zero_counts, read_counts, **step_kw) -> tuple[list, list, dict, float]:
    """`steps` Adam steps through the trainer's `train_step` (dropout and
    the LSH draws from `gen`; `step_kw` to it), each timed to its
    synchronise; launch counters zeroed just before and read just after;
    the losses must be finite. Returns (step ms, losses, launches, peak
    GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms, losses = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        m = trainer.train_step(model, opt, loss_fn, batch, gen, **step_kw)
        losses.append(float(m["loss"]))  # synchronises
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  {label} step {s}: loss={losses[-1]:.6f} "
            f"grad_norm={float(m['grad_norm']):.4f} {step_ms[-1]:.1f} ms")
    launches = read_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    return step_ms, losses, launches, torch.cuda.max_memory_allocated() / 2**30


def timed_eval(torch, trainer, cfg, model, ds, n_max: int, want: dict, label: str,
               zero_counts, read_counts, plain_keys=None) -> tuple[dict, float, dict]:
    """One `evaluate` of split "test" of `ds` after a warm-up (which packs
    and caches the split), timed to its host read; launches counted (each
    counter in `want` must read its value); metrics finite and in [0, 1].
    With `plain_keys`, those metrics and the loss are held against the same
    evaluation under `plain_reference()` (loss 1e-3 relative, metrics
    5e-3). Returns (metrics, ms, launches)."""
    from hept_tpu_torch.ops.dispatch import plain_reference

    block_size = cfg.model_kwargs.get("block_size", 100)
    trainer.evaluate(cfg, model, ds, "test", block_size, n_max)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.evaluate(cfg, model, ds, "test", block_size, n_max)  # ends in a host read
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"{label}: eval launches (got, want) {bad}")
    out_of_range = {k: v for k, v in res.items()
                    if not math.isfinite(v) or (k != "loss" and not 0.0 <= v <= 1.0)}
    if out_of_range or not set(plain_keys or ()) <= set(res):
        raise AssertionError(f"{label}: eval metrics out of range or missing: {res}")
    log(f"phase {label} eval: evaluate() of the event {eval_ms:.1f} ms; "
        f"launches {launches}; " + " ".join(f"{k}={v:.6f}" for k, v in res.items()))
    if plain_keys:
        with plain_reference():
            plain = trainer.evaluate(cfg, model, ds, "test", block_size, n_max)
        log("  plain: " + " ".join(f"{k}={v:.6f}" for k, v in plain.items()))
        check(f"{label} eval loss |d| (kernels vs plain)", abs(res["loss"] - plain["loss"]),
              1e-3 * abs(plain["loss"]))
        worst = max(plain_keys, key=lambda k: abs(res[k] - plain[k]))
        check(f"{label} eval metrics max|d| (kernels vs plain, worst {worst})",
              abs(res[worst] - plain[worst]), 5e-3)
    return res, eval_ms, launches


def phase_profile(torch, trainer, profile: str, batch_np, ds, steps: int, seed: int,
                  zero_counts, read_counts, fwd: str, bwd: str, task: str = "tracking") -> dict:
    """A profile of the task at full width: `steps` timed Adam steps with
    dropout, launches counted (the bucket forward and backward on the
    counters `fwd` and `bwd`, 4 each a step, no other bucket kernel; the
    pair kernels for tracking, none for pileup); one timed `evaluate` of the
    event (split "test" of `ds`), launches counted, and for pileup held
    against the same evaluation under `plain_reference()`; then the first
    step, dropout off, with kernels and with plain versions, compared."""
    from hept_tpu_torch.train.config import profile_config

    cfg = profile_config(profile, task=task, device=DEVICE, num_epochs=1)
    label = profile if task == "tracking" else f"{task} {profile}"
    pairs_step = PAIR_LAUNCHES_STEP if task == "tracking" else dict.fromkeys(PAIR_LAUNCHES_STEP, 0)
    pairs_eval = PAIR_LAUNCHES_EVAL if task == "tracking" else dict.fromkeys(PAIR_LAUNCHES_EVAL, 0)
    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    loss_fn = trainer.make_loss_fn(cfg)
    gen_drop = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    step_ms, losses, launches, peak = timed_steps(torch, trainer, model, opt, loss_fn, batch,
                                                  gen_drop, steps, label, zero_counts,
                                                  read_counts)
    # per step and layer: one bucket forward and backward, the unsort's K5
    # forward and backward
    want = {**NO_K6_K7, **NO_K1_K2, fwd: 4 * steps, bwd: 4 * steps,
            "rows_fwd": 0, "rows_bwd": 0, "row_gather": 8 * steps,
            **{k: v * steps for k, v in pairs_step.items()}}
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{label}: {k} launched {launches[k]}x in {steps} steps, "
                                 f"want {v}")
    steady = statistics.median(step_ms[1:])
    log(f"phase {label}: {steps} steps (bs {cfg.model_kwargs['block_size']}, "
        f"{cfg.model_kwargs['n_hashes']} hashes, attn_impl {cfg.attn_impl}, dropout on), "
        f"losses {losses}; step ms {step_ms}; median after the first {steady:.1f} ms; "
        f"launches {launches}; peak memory {peak:.2f} GiB")
    del opt

    # per layer: one bucket forward and the unsort's K5; no backward
    _, eval_ms, eval_launches = timed_eval(
        torch, trainer, cfg, model, ds, batch_np["x"].shape[1],
        {**NO_K6_K7, **NO_K1_K2, fwd: 4, "row_gather": 4, **pairs_eval}, label, zero_counts,
        read_counts, plain_keys=("auc", "roc", "f1") if task == "pileup" else None)

    model.load_state_dict(init_state)
    compare_first_step(torch, label, cfg, model, loss_fn, batch)
    del model, init_state
    torch.cuda.empty_cache()
    return {"launches": launches, "eval_launches": eval_launches, "steady_ms": steady,
            "eval_ms": eval_ms, "peak_gib": peak}


def phase_baseline(torch, trainer, attn: str, task: str, batch_np, ds, steps: int, seed: int,
                   zero_counts, read_counts, cfg=None) -> dict:
    """A baseline at its YAML's widths and lr on one full-width event of the
    task (an attention `attn` of `profile_config`, or the model of `cfg`: a
    GNN): `steps` Adam steps with dropout and the LSH draws from the step's
    generator, launches counted (K3 / K4 as the InfoNCE loss launches them
    for tracking; no other kernel of the port: the baselines' attention and
    the GNNs' message passing are plain PyTorch, as JAX computes them outside
    any Pallas kernel), then one more step under torch.profiler for the
    device's busy time, K3 / K4's share and torch.topk's; one timed
    `evaluate` (its launches counted) against the same evaluation under
    `plain_reference()`; then the first step, dropout off and the fixed
    draws, with kernels and under `plain_reference()` (the LSH baselines on
    the kernel run's sort orders, DGCNN / GravNet on its neighbours),
    compared at the f32 levels."""
    from hept_tpu_torch.train.config import profile_config
    from hept_tpu_torch.utils.profiling import port_kernels_ms, profile_device, topk_ms

    if cfg is None:
        cfg = profile_config(attn, task=task, device=DEVICE, num_epochs=1)
    label = f"{task} {attn}"
    pairs_step = PAIR_LAUNCHES_STEP if task == "tracking" else {}
    pairs_eval = PAIR_LAUNCHES_EVAL if task == "tracking" else {}
    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    loss_fn = trainer.make_loss_fn(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    step_ms, losses, launches, peak = timed_steps(torch, trainer, model, opt, loss_fn, batch,
                                                  gen, steps, label, zero_counts, read_counts)
    no_kernel = dict.fromkeys(launches, 0)
    want = {**no_kernel, **{k: v * steps for k, v in pairs_step.items()}}
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad} in {steps} steps")
    prof_ms, kernel_us, _ = profile_device(
        lambda: trainer.train_step(model, opt, loss_fn, batch, gen), 1)
    busy_ms = sum(kernel_us.values()) / 1e3
    ours = port_kernels_ms(kernel_us)
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:4]
    res = {"step_ms": step_ms, "steady_ms": statistics.median(step_ms[1:] or step_ms),
           "profiled_step_ms": prof_ms, "busy_ms": busy_ms, "peak_gib": peak,
           "k3_ms": ours.get("K3", 0.0), "k4_ms": ours.get("K4", 0.0),
           "topk_ms": topk_ms(kernel_us), "launches": launches, "losses": losses}
    widths = {k: v for k, v in cfg.model_kwargs.items()
              if k in ("h_dim", "hidden_dim", "n_layers", "num_layers", "out_dim", "k", "knn_dim")}
    log(f"phase {label}: {steps} steps ({widths}, lr {cfg.optimizer_kwargs['lr']:g}, dropout "
        f"on), losses {losses}; step ms {step_ms}; profiled step {prof_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, K3 {res['k3_ms']:.3f} ms, K4 {res['k4_ms']:.3f} ms, torch.topk "
        f"{res['topk_ms']:.3f} ms; peak memory {peak:.2f} GiB; launches "
        + str({k: v for k, v in launches.items() if v}) + "; top kernels (ms): "
        + "; ".join(f"{name[:90]} {us / 1e3:.2f}" for name, us in top))
    del opt

    res["eval"], res["eval_ms"], _ = timed_eval(
        torch, trainer, cfg, model, ds, batch_np["x"].shape[1], {**no_kernel, **pairs_eval},
        label, zero_counts, read_counts,
        plain_keys=("auc", "roc", "f1") if task == "pileup" else
        tuple(f"{m}@{t}" for t in ("0", "0.5", "0.9") for m in ("accuracy", "precision",
                                                                 "recall")))

    model.load_state_dict(init_state)
    compare_first_step(torch, label, cfg, model, loss_fn, batch)
    del model, init_state, batch
    torch.cuda.empty_cache()
    return res


def phase_cpu_vs_card(torch, trainer, seed: int, points: int = 1200) -> None:
    """Each baseline attention and each GNN at its YAML's widths (tracking;
    2 layers) on a `points`-point event: the same weights and fixed draws on
    the CPU and on the card, outputs held at relative max|d| <= 1e-4. The
    CPU's choices are imposed on both runs, so a near-tie that rounding
    flips cannot move a point: the LSH baselines' sort orders, the GNNs'
    fixed graph and learned-space neighbours (recorded by a forward before).
    This holds the card's plain ops to the CPU, which the CPU tests hold to
    JAX. pct and the gated / GCN convs sum their messages per destination
    (`ops/segment.py`): whether two card calls give the same bits is
    printed for each model."""
    from hept_tpu_torch.models.gnns import CONVS, GRAPH_CONVS, gnn_graph
    from hept_tpu_torch.models.transformer import BASELINES
    from hept_tpu_torch.train.config import gnn_config_path, load_config, profile_config

    def to_card(choice):
        return tuple(to_card(t) for t in choice) if isinstance(choice, tuple) \
            else choice.to(DEVICE)

    _, batch_np = make_batch(points, seed, 100)
    cpu = trainer.batch_to_device(batch_np, "cpu")
    card = trainer.batch_to_device(batch_np, DEVICE)
    models = [(attn, profile_config(attn, device="cpu", num_epochs=1), "n_layers")
              for attn in BASELINES]
    models += [(f"gnn {conv}", load_config(gnn_config_path(conv), device="cpu", num_epochs=1),
                "num_layers") for conv in CONVS]
    for label, cfg, layers in models:
        cfg.model_kwargs[layers] = 2
        model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                    torch.Generator().manual_seed(seed), "cpu")
        gnn = cfg.model_name.startswith("gnn_")
        record, impose = ("record_nbrs", "nbrs") if gnn else ("record_perms", "perms")
        args_cpu = (cpu["x"][0], cpu["coords"][0], cpu["valid"][0])
        fixed = {}
        if gnn and cfg.model_name[len("gnn_"):] in GRAPH_CONVS:
            fixed["graph"] = gnn_graph(*args_cpu[1:], model.cfg.graph_k)
        chosen = []
        with torch.no_grad():
            model(*args_cpu, **fixed, **{record: chosen})
            want = model(*args_cpu, **fixed, **{impose: chosen or None})
            model.to(DEVICE)
            kw = {**{k: to_card(v) for k, v in fixed.items()},
                  impose: [to_card(c) for c in chosen] or None}
            args = (card["x"][0], card["coords"][0], card["valid"][0])
            got = model(*args, **kw)
            again = model(*args, **kw)
        real = cpu["valid"][0]
        err = max_err(got.cpu()[real], want[real]) / scale(want[real])
        same = "gave the same bits" if torch.equal(got, again) else "differ"
        check(f"{label} at {want.shape[0]} points, card vs CPU, max|d| / max|out| (two card "
              f"calls {same})", err, 1e-4)
        del model, got, again
    torch.cuda.empty_cache()


def phase_train_options(torch, trainer, event, batch_np, seed: int, zero_counts,
                        read_counts) -> dict:
    """The trainer's loss and optimizer options on the full-width hept_acc
    model and the phase-3 event: one step (dropout on) each of the windowed
    InfoNCE with dist_metric cosine and l2_inverse (`partner_gather`'s
    backward is a K4: PAIR_LAUNCHES_PARTNER), of the triplet loss and of the
    InfoNCE on the pair list as packed (`windowed_pairs: false`; neither
    launches K3 or K4), launches counted with the model's own (K1 / K2 4
    each on the tensor cores, K5 8); each one's first step, dropout off,
    with kernels against `plain_reference()`; then three steps of AdamW
    (weight decay 0.01) under the per-step cosine schedule with clip_norm,
    each lr held to the schedule's formula, and that step's clipped
    gradient with kernels against plain."""
    from hept_tpu_torch.data.batching import pack_events
    from hept_tpu_torch.ops.dispatch import plain_reference
    from hept_tpu_torch.train.config import profile_config
    from hept_tpu_torch.train.optim import make_lr_scheduler, make_optimizer

    model_kernels = {"bucket_attn_fwd_tc": 4, "bucket_attn_bwd_tc": 4, "bucket_attn_fwd": 0,
                     "bucket_attn_bwd": 0, **NO_K6_K7, "rows_fwd": 0, "rows_bwd": 0,
                     "row_gather": 8}
    n_max = batch_np["x"].shape[1]
    base = profile_config("hept_acc", device=DEVICE, num_epochs=1)
    list_np = pack_events([event], block_size=base.model_kwargs["block_size"], n_max=n_max)
    cases = {
        "cosine": ({"loss_kwargs": {"tau": 0.05, "dist_metric": "cosine"}}, batch_np,
                   PAIR_LAUNCHES_PARTNER),
        "l2_inverse": ({"loss_kwargs": {"tau": 0.05, "dist_metric": "l2_inverse"}}, batch_np,
                       PAIR_LAUNCHES_PARTNER),
        "triplet": ({"loss_name": "triplet", "loss_kwargs": {"margin": 0.5}}, batch_np, NO_PAIRS),
        "pair_list": ({"windowed_pairs": False}, list_np, NO_PAIRS),
    }
    gen_init = torch.Generator(device=DEVICE).manual_seed(seed)
    model = trainer.build_model(base, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                gen_init, DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    out = {}
    for name, (over, bnp, pairs) in cases.items():
        cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1, **over)
        if trainer._window_pairs(cfg) != (128 if "pair_rev" in bnp else 0):
            raise AssertionError(f"{name}: the trainer would pack another layout")
        batch = trainer.batch_to_device(bnp, DEVICE)
        loss_fn = trainer.make_loss_fn(cfg)
        model.load_state_dict(init_state)
        opt = trainer.make_optimizer(model.parameters(), "adam", 1e-2)
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        step_ms, losses, launches, _ = timed_steps(torch, trainer, model, opt, loss_fn, batch,
                                                   gen, 1, f"option {name}", zero_counts,
                                                   read_counts)
        want = {**model_kernels, **pairs}
        bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if bad:
            raise AssertionError(f"option {name}: launches (got, want) {bad}")
        log(f"phase options {name}: one hept_acc step {step_ms[0]:.1f} ms, loss {losses[0]:.6f}; "
            "pair launches " + str({k: launches[k] for k in pairs}))
        out[name] = {k: launches[k] for k in pairs}
        model.load_state_dict(init_state)
        compare_first_step(torch, f"option {name}", cfg, model, loss_fn, batch)
        del opt, batch

    # AdamW, the per-step cosine schedule and clip_norm: 3 updates, warm-up 2
    base_lr, clip, wd, warm, epochs, eta_ratio = 1e-2, 0.05, 0.01, 2, 3, 0.1
    batch = trainer.batch_to_device(batch_np, DEVICE)
    loss_fn = trainer.make_loss_fn(base)

    def clipped_step(plain: bool):
        model.load_state_dict(init_state)
        opt = make_optimizer(model.parameters(), "adamw", base_lr, weight_decay=wd)
        if plain:
            with plain_reference():
                m = trainer.train_step(model, opt, loss_fn, batch, clip_norm=clip)
        else:
            m = trainer.train_step(model, opt, loss_fn, batch, clip_norm=clip)
        return float(m["grad_norm"]), {k: p.grad.detach().clone()
                                       for k, p in model.named_parameters() if p.grad is not None}

    norm_k, grads_k = clipped_step(False)
    norm_p, grads_p = clipped_step(True)
    clipped = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads_k.values()))
    log(f"phase options adamw: first step's gradient norm kernels {norm_k:.6f} plain "
        f"{norm_p:.6f}, clipped to {clipped:.6f} (clip_norm {clip})")
    if norm_k >= clip:
        check("adamw clipped gradient norm / clip_norm - 1", abs(clipped / clip - 1), 1e-5)
    diff2 = sum(float((grads_k[k] - grads_p[k]).double().pow(2).sum()) for k in grads_p)
    norm2 = sum(float(grads_p[k].double().pow(2).sum()) for k in grads_p)
    check("adamw clipped gradient, |g_kernels - g_plain| / |g_plain|", math.sqrt(diff2 / norm2),
          1e-2)
    model.load_state_dict(init_state)
    opt = make_optimizer(model.parameters(), "adamw", base_lr, weight_decay=wd)
    sched = make_lr_scheduler(opt, "cosine", steps_per_epoch=1, num_epochs=epochs,
                              num_warmup_epochs=warm, eta_min_ratio=eta_ratio)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    lrs = []
    for i in range(3):
        lr = opt.param_groups[0]["lr"]
        # the formula, written out: linear warm-up, then the cosine to eta_min
        if i < warm:
            want = base_lr * max(i, 1) / warm
        else:
            prog = min(max((i - warm) / max(epochs - warm, 1), 0.0), 1.0)
            eta = base_lr * eta_ratio
            want = eta + 0.5 * (base_lr - eta) * (1 + math.cos(math.pi * prog))
        m = trainer.train_step(model, opt, loss_fn, batch, gen, clip_norm=clip)
        sched.step()
        lrs.append(lr)
        log(f"  adamw + cosine step {i}: lr {lr:.8g} (formula {want:.8g}) loss "
            f"{float(m['loss']):.6f} grad_norm {float(m['grad_norm']):.4f}")
        check(f"adamw + cosine step {i} lr vs formula, relative", abs(lr - want) / want, 1e-12)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("adamw + cosine: non-finite loss")
    out["adamw_cosine_lrs"] = lrs
    del model, init_state, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_core(torch, trainer, batch_np, seed: int, zero_counts, read_counts) -> dict:
    """The row-major core `hept_attention_core` forward and backward at the
    parity profile's full width (h 8, c 3, d_hash 30, dv 24, bs 100) on the
    bs-100 event: its own AND codes and inert rows, and q_hat / k_hat / v of
    the parity model's layer 0 (random weights from the seed); launches
    counted (K10 one each way, K5 eight); against the same run under
    `plain_reference()` on its permutations. Then K10 alone against its plain
    version on the sorted operands of that run, timed. Returns the K10 rows
    and the core run's launch counts."""
    from hept_tpu_torch.core.buckets import sort_carry_rows
    from hept_tpu_torch.models.transformer import prepare_event
    from hept_tpu_torch.ops import bucket_attn_cuda as ba
    from hept_tpu_torch.ops.bucket_attn import hept_attention_core
    from hept_tpu_torch.ops.dispatch import plain_reference
    from hept_tpu_torch.train.config import profile_config

    cfg = profile_config("hept", device=DEVICE)
    bs = cfg.model_kwargs["block_size"]
    batch = trainer.batch_to_device(batch_np, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2], gen,
                                DEVICE)
    blk = model.blocks[0]
    with torch.no_grad():
        x, coords, codes, invalid = prepare_event(batch["x"][0], batch["coords"][0],
                                                  batch["valid"][0], model.regions, bs)
        xn = blk.norm1(model.feat_enc_1(torch.relu(model.feat_enc_0(x))))
        cols = blk.attn.prep_qkv(blk.w_q(xn), blk.w_k(xn), blk.w_v(xn), coords, invalid,
                                 blk.w_rpe)
    ins = [c_.transpose(1, 2).contiguous().requires_grad_(True) for c_ in cols]  # (h, n, .)
    alpha = blk.attn.e2lsh_alpha
    h, n, d = ins[0].shape
    dv, c = ins[2].shape[-1], alpha.shape[-1]
    w = torch.randn((h, n, dv), generator=gen, device=DEVICE)
    del model, x, xn, cols
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    perms = []
    out = hept_attention_core(*ins, alpha, codes, invalid, block_size=bs, impl="pallas",
                              record_perms=perms)
    grads = torch.autograd.grad((out * w).sum(), ins)
    torch.cuda.synchronize()
    core_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    want = {"rows_fwd": 1, "rows_bwd": 1, "row_gather": 8, **NO_K1_K2, **NO_K6_K7}
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"hept_attention_core launched {k} {launches[k]}x, want {v}")
    if tuple(out.shape) != (h, n, dv) or not torch.isfinite(out).all() \
            or not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"core output {tuple(out.shape)} not finite / wrong shape")
    log(f"phase core: hept_attention_core forward + backward (h={h} c={c} d_hash={d} dv={dv} "
        f"n={n} bs={bs}, parity layer 0) {core_ms:.1f} ms (first call); launches {launches}")
    with plain_reference():
        out_p = hept_attention_core(*ins, alpha, codes, invalid, block_size=bs, impl="pallas",
                                    perms=perms[0])
        grads_p = torch.autograd.grad((out_p * w).sum(), ins)
    # f32 sums of 100 terms in other orders (K10, then the sum over rounds)
    check("core output max|d| (kernels vs plain, same permutations)", max_err(out, out_p),
          1e-5 * scale(out_p))
    for nm, a, b in zip(("q_hat", "k_hat", "v"), grads, grads_p):
        check(f"core d{nm} max|d|", max_err(a, b), 1e-4 * scale(b))
    del out, out_p, grads, grads_p

    # K10 alone on the sorted operands of that run: 14400 buckets of 100
    q_src, k_src = perms[0]
    with torch.no_grad():
        g = c * h * (n // bs)
        sq = sort_carry_rows(None, ins[0].detach(), src=q_src)[0].reshape(g, bs, d)
        sk = sort_carry_rows(None, ins[1].detach(), src=k_src)[0].reshape(g, bs, d)
        sv = sort_carry_rows(None, ins[2].detach(), src=k_src)[0].reshape(g, bs, dv)
    g_den = torch.randn((g, bs, 1), generator=gen, device=DEVICE)
    g_so = torch.randn((g, bs, dv), generator=gen, device=DEVICE)
    routes = (ba.rows_fwd_route(bs), ba.rows_bwd_route(bs, d, dv))
    log(f"kernel K10 rows_fwd / rows_bwd (f32, {g} buckets of {bs}, d={d} dv={dv}; routes "
        f"{routes[0]} / {routes[1]}):")
    errs = []
    fwd = ba.rows_fwd_cuda(sq, sk, sv)
    fwd_p = ba.rows_fwd_plain(sq, sk, sv)
    for nm, a, b in zip(("denom", "so"), fwd, fwd_p):
        errs.append(max_err(a, b))
        check(f"K10 fwd {nm} max|d|", errs[-1], 1e-4 * scale(b))
    e_fwd = max(errs)
    errs = []
    bwd = ba.rows_bwd_cuda(sq, sk, sv, g_den, g_so)
    for nm, a, b in zip(("dq", "dk", "dv"), bwd, ba.rows_bwd_plain(sq, sk, sv, g_den, g_so)):
        errs.append(max_err(a, b))
        check(f"K10 bwd {nm} max|d|", errs[-1], 1e-4 * scale(b))
    e_bwd = max(errs)
    for label, first, call in (("fwd", fwd, lambda: ba.rows_fwd_cuda(sq, sk, sv)),
                               ("bwd", bwd, lambda: ba.rows_bwd_cuda(sq, sk, sv, g_den, g_so))):
        same_bits(torch, f"K10 {label}", first, call)
    # the tiled forward runs K6 f32's arithmetic: its bits on the transposed
    # operands, (1, d, g * bs) columns
    if routes[0] == "tiled":
        cols = [t.reshape(g * bs, -1).t().contiguous()[None] for t in (sq, sk, sv)]
        want = [t[0].t().reshape(a.shape) for t, a in zip(ba.cols_fwd_cuda(*cols, bs), fwd)]
        if not all(torch.equal(a, b) for a, b in zip(fwd, want)):
            raise AssertionError("K10 fwd (tiled) differs in its bits from K6 f32 on the "
                                 "transposed operands")
        log("  K10 fwd (tiled): the bits of K6 f32 on the transposed operands")
        del cols, want
    # both sides against a float64 run: the logit q.k - |q|^2/2 - |k|^2/2
    # cancels large RPE norms, so f32 rounding in either order shows there
    with torch.no_grad():
        ops64 = [t.double() for t in (sq, sk, sv, g_den, g_so)]
        for label, names, got, plain, ref in (
                ("fwd", ("denom", "so"), fwd, fwd_p, ba.rows_fwd_plain(*ops64[:3])),
                ("bwd", ("dq", "dk", "dv"), bwd, ba.rows_bwd_plain(sq, sk, sv, g_den, g_so),
                 ba.rows_bwd_plain(*ops64))):
            for nm, a, b, r_ in zip(names, got, plain, ref):
                log(f"  K10 {label} {nm} max|d| against float64: kernel "
                    f"{float((a.double() - r_).abs().max()):.3e}, plain "
                    f"{float((b.double() - r_).abs().max()):.3e}")
        del ops64, ref, plain, bwd
    # the library yardstick on the row layout: g batches of one bucket (the
    # operands as (g, d, bs) columns)
    lib = library_yardstick(torch, *(t.transpose(1, 2) for t in (sq, sk, sv)), bs,
                            [t.transpose(1, 2) for t in fwd_p])
    del fwd, fwd_p
    rows = {}
    pts = g * bs
    for key, name, src_line, err, fl, by, kern, plain in (
            ("K10f", "K10 rows_fwd", "146", e_fwd, 2.0 * pts * bs * (d + dv),
             4.0 * pts * (2 * d + dv) + 4.0 * pts * (dv + 1),
             lambda: ba.rows_fwd_cuda(sq, sk, sv), lambda: ba.rows_fwd_plain(sq, sk, sv)),
            ("K10b", "K10 rows_bwd", "194", e_bwd, 2.0 * pts * bs * (3 * d + 2 * dv),
             4.0 * pts * (2 * d + 2 * dv + 1) + 4.0 * pts * (2 * d + dv),
             lambda: ba.rows_bwd_cuda(sq, sk, sv, g_den, g_so),
             lambda: ba.rows_bwd_plain(sq, sk, sv, g_den, g_so))):
        b_ms, b_by = bound_ms(by, fl, F32_FLOP_PER_S)
        fwd_row = key == "K10f"
        rows[key] = dict(name=name, route="cuda", source="hept_tpu_torch/csrc/bucket_attn.cu",
                         replaces=f"hept_tpu/ops/bucket_attn_pallas.py:{src_line}",
                         launches=launches["rows_fwd" if fwd_row else "rows_bwd"],
                         max_abs_err=err, ms=graph_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                         bound_ms=b_ms, bound_by=b_by, kernel_route=routes[0 if fwd_row else 1],
                         events_ms=time_ms(kern),
                         # no single PyTorch call takes the backward's
                         # independent cotangents g_so and g_den
                         **(lib if fwd_row else {"library_ms": None}))
        row = rows[key]
        log(f"  {name} ({row['kernel_route']}): kernel {row['ms']:.4f} ms device "
            f"({row['events_ms']:.4f} ms by events), plain {row['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, at the FP32 peak {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    log_library(rows["K10f"])
    del sq, sk, sv, g_den, g_so, ins, w
    torch.cuda.empty_cache()
    return rows, launches


def phase_slab(torch, trainer, batch_np, seed: int, zero_counts, read_counts) -> dict:
    """`attn_impl: slab` and `hybrid_slab` (the JAX package's slab kernels
    K8/K9, run as K6 hi/lo + K7 v1 and K6 + K7 v1) in the full-width
    hept_fast profile on the bs-100 event: one Adam step each with dropout,
    launches counted (K6 4 on the tensor cores, K7 v1 4 on FP32 FMAs, K5 8,
    K1/K2/K10 none), then the first step with kernels and plain versions
    compared at hept_fast's levels."""
    from hept_tpu_torch.train.config import profile_config

    batch = trainer.batch_to_device(batch_np, DEVICE)
    out = {}
    for mode in ("slab", "hybrid_slab"):
        cfg = profile_config("hept_fast", device=DEVICE, num_epochs=1, attn_impl=mode)
        model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                    torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
        init_state = copy.deepcopy(model.state_dict())
        opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                     cfg.optimizer_kwargs["lr"])
        loss_fn = trainer.make_loss_fn(cfg)
        gen_drop = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        m = trainer.train_step(model, opt, loss_fn, batch, gen_drop)
        loss = float(m["loss"])  # synchronises
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        if not math.isfinite(loss):
            raise AssertionError(f"hept_fast {mode}: non-finite loss {loss}")
        want = {**NO_K6_K7, "cols_fwd_tc": 4, "cols_bwd": 4, **NO_K1_K2,
                "rows_fwd": 0, "rows_bwd": 0, "row_gather": 8, **PAIR_LAUNCHES_STEP}
        for k, v in want.items():
            if launches[k] != v:
                raise AssertionError(f"hept_fast {mode}: {k} launched {launches[k]}x, want {v}")
        log(f"phase slab: hept_fast with attn_impl {mode}, one step (first call), loss={loss:.6f} "
            f"{step_ms:.1f} ms; launches {launches}")
        out[mode] = launches
        del opt
        model.load_state_dict(init_state)
        compare_first_step(torch, f"hept_fast {mode}", cfg, model, loss_fn, batch)
        del model, init_state
        torch.cuda.empty_cache()
    return out


def sort_inputs(torch, rows: int, n: int, ops: int, seed: int):
    """K12's inputs: (rows, n) keys with a +BIG tail and interior ties (-0.0
    and +0.0 among them), ops - 1 random int32 payloads and the row-position
    iota (the tie-break)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randn((rows, n), generator=gen, device=dev)
    keys[:, -min(n, 600):] = 3.0e38
    keys[:, :2000] = torch.round(keys[:, :2000] * 10) / 10
    keys[:, :4] = torch.tensor([-0.0, 0.0, -0.0, 0.0], device=dev)[:n]
    pays = [torch.randint(-2**31, 2**31 - 1, (rows, n), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(ops - 1)]
    pays.append(torch.arange(n, device=dev, dtype=torch.int32).expand(rows, n).contiguous())
    return keys, pays


def sort_library(torch, keys, pays):
    """K12's library yardstick: `torch.sort(stable=True)` and one gather per
    payload (the same function for an iota tie-break)."""
    idx = torch.sort(keys, dim=-1, stable=True).indices
    return [p.gather(-1, idx) for p in pays]


def kernel_breakdown(torch, fn, calls: int = 5) -> dict:
    """Device microseconds per call of `fn`, by kernel name (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            name = evt.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
            us[name] = us.get(name, 0.0) + evt.time_range.elapsed_us() / calls
    return us


def k12_yardsticks(torch, srt, seed: int) -> dict:
    """K12 at 24 rows x 60000 keys x 16 payloads through the wrapper every
    tree has: device time by CUDA graph replay beside the library yardstick
    and the byte bound, a digest of the output bits, and the device time of
    each kernel one call launches."""
    rows, n, ops = 24, 60000, 16
    keys, pays = sort_inputs(torch, rows, n, ops, seed)
    fn = lambda: srt.bitonic_sort_rows_cuda(keys, pays)  # noqa: E731
    out = {"bits": bits_digest(fn()), "device_ms": graph_ms(fn),
           "library_ms": graph_ms(lambda: sort_library(torch, keys, pays)),
           "bound_ms": bound_ms(4.0 * rows * n * (1 + 2 * ops), 0.0, F32_FLOP_PER_S)[0],
           "kernels_us": kernel_breakdown(torch, fn)}
    del keys, pays
    torch.cuda.empty_cache()
    return out


def sort_exact(torch, srt, keys, pays, zero_counts, read_counts) -> tuple[str, int]:
    """One K12 call through `bitonic_sort_rows` with the counters zeroed just
    before and read just after: one launch on the route `sort_route` picks,
    none on the other, every payload bit-equal to the plain version.
    Returns the route and its launches."""
    route = srt.sort_route(*keys.shape, len(pays))
    torch.cuda.synchronize()
    zero_counts()
    got = srt.bitonic_sort_rows(keys, pays)
    torch.cuda.synchronize()
    launches = read_counts()
    want_launches = {k: int(k == f"sort_{route}") for k in srt.LAUNCHES}
    if {k: launches[k] for k in srt.LAUNCHES} != want_launches:
        raise AssertionError(f"K12 launches {launches}, want {want_launches}")
    want = srt.bitonic_sort_rows_plain(keys, pays)
    for j, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"K12 ({route} route) payload {j}: kernel and plain version "
                                 f"differ in {int((a != b).sum())} elements")
    check(f"K12 {route} route, {tuple(keys.shape)} x {len(pays)} payloads, max|d| (bit patterns)",
          max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, want)), 0.0)
    return route, launches[f"sort_{route}"]


def phase_sort(torch, seed: int, zero_counts, read_counts) -> dict:
    """K12 through `bitonic_sort_rows` on 24 rows of 60000 keys (a +BIG tail
    and interior ties, -0.0 and +0.0 among them) carrying 15 payloads and
    the row-position iota (the cluster route), launches counted per route;
    bit-equal to its plain version; timed by CUDA graph replay against
    `torch.sort(stable=True)` plus the payload gathers, the plain version by
    CUDA events. Then the bitonic route once at a shape that takes it (4 rows
    of 70000 keys, 4 payloads), the same way."""
    from hept_tpu_torch.ops import sort as srt

    rows, n, ops = 24, 60000, 16
    keys, pays = sort_inputs(torch, rows, n, ops, seed)
    log(f"kernel K12 bitonic_sort_rows ({rows} rows x {n} keys, {ops} payloads; exact):")
    route, launches = sort_exact(torch, srt, keys, pays, zero_counts, read_counts)
    b_ms, b_by = bound_ms(4.0 * rows * n * (1 + 2 * ops), 0.0, F32_FLOP_PER_S)
    row = dict(name="K12 bitonic_sort_rows", route="cuda", source="hept_tpu_torch/csrc/sort.cu",
               replaces="hept_tpu/ops/sort_pallas.py:158", launches=launches, max_abs_err=0.0,
               ms=graph_ms(lambda: srt.bitonic_sort_rows_cuda(keys, pays)),
               plain_ms=time_ms(lambda: srt.bitonic_sort_rows_plain(keys, pays), 20),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=graph_ms(lambda: sort_library(torch, keys, pays)), sort_route=route)
    log(f"  K12 ({route} route): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library (torch.sort stable + {ops} gathers) {row['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) (device ms by graph replay; plain by events)")
    del keys, pays
    keys, pays = sort_inputs(torch, 4, 70000, 4, seed + 1)
    row["other_route"], row["other_route_launches"] = sort_exact(torch, srt, keys, pays,
                                                                 zero_counts, read_counts)
    row["other_route_shape"] = "4 x 70000 keys, 4 payloads"
    del keys, pays
    torch.cuda.empty_cache()
    return row


def bits_digest(tensors) -> str:
    """A short digest of the tensors' bytes: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bucket_yardsticks(torch, ba, n: int, seed: int) -> dict:
    """K2 at the main path's shape (bf16, r 16, bs 512, tensor cores), K6 and
    K7 on each of their paths' inputs (K6 f32 at the parity shape, bf16 with
    exact and with hi/lo bias (= K8) at hept_fast's; K7 v1 f32 at the parity
    shape, v2 bf16 at hept_fast's, v1 on bf16 = K9), through the wrappers
    every tree has: device time by CUDA graph replay and a digest of the
    outputs' bits, on inputs made here from the seed (the same in every
    tree)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    out = {}
    r, bs = 16, 512
    qk2 = [torch.cat([rn(r, 24, n, s=0.3), rn(r, 6, n, s=0.5)], 1).to(torch.bfloat16)
           .contiguous() for _ in range(2)]
    sv, g_den, g_so = rn(r, 24, n).to(torch.bfloat16), rn(r, 1, n), rn(r, 24, n)
    fn = lambda: ba.bucket_attn_bwd_cuda(*qk2, sv, g_den, g_so, bs)  # noqa: E731
    out["K2_bits"] = bits_digest(fn())
    out["K2_device_ms"] = graph_ms(fn)
    del qk2, sv, g_den, g_so
    n, bs = 60000, 100
    for key, r, dtype, v2, common in (("K7_v1_f32", 24, torch.float32, False, 2.0),
                                      ("K7_v2_bf16", 16, torch.bfloat16, True, 0.0),
                                      ("K9_v1_bf16", 16, torch.bfloat16, False, 0.0)):
        shared = rn(r, 6, n // bs, 1, s=common)

        def qk():
            x = rn(r, 30, n // bs, bs, s=0.5)
            x[:, 24:] += shared
            return x.reshape(r, 30, n).to(dtype).contiguous()

        ins = (qk(), qk(), rn(r, 24, n).to(dtype), rn(r, 1, n), rn(r, 24, n))
        fn = lambda: ba.cols_bwd_cuda(*ins, bs, v2)  # noqa: E731
        out[f"{key}_bits"] = bits_digest(fn())
        out[f"{key}_device_ms"] = graph_ms(fn, 10)
        del ins
    for key, r, dtype, hilo, common in (("K6_f32", 24, torch.float32, False, 2.0),
                                        ("K6_bf16", 16, torch.bfloat16, False, 0.0),
                                        ("K6_hilo_bf16", 16, torch.bfloat16, True, 0.0)):
        shared = rn(r, 6, n // bs, 1, s=common)
        ins = [rn(r, 30, n // bs, bs, s=0.5) for _ in range(2)]
        for x in ins:
            x[:, 24:] += shared
        ins = [x.reshape(r, 30, n).to(dtype).contiguous() for x in ins] + [rn(r, 24, n).to(dtype)]
        fn = lambda: ba.cols_fwd_cuda(*ins, bs, hilo)  # noqa: E731
        out[f"{key}_bits"] = bits_digest(fn())
        out[f"{key}_device_ms"] = graph_ms(fn, 10)
        del ins
    torch.cuda.empty_cache()
    return out


def k10_yardsticks(torch, ba, seed: int) -> dict:
    """K10 forward and backward at the parity core's shape (14400 buckets of
    100, d 30, dv 24, f32; q / k with an RPE-like common mode of 2 per
    bucket, as K6 / K7 v1's yardsticks), through the wrappers every tree has:
    device time by CUDA graph replay and a digest of the outputs' bits, on
    inputs made here from the seed (the same in every tree)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, bs = 14400, 100

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    shared = rn(g, 1, 6, s=2.0)
    sq, sk = (torch.cat([rn(g, bs, 24, s=0.5), rn(g, bs, 6, s=0.5) + shared], -1)
              for _ in range(2))
    sv, g_den, g_so = rn(g, bs, 24), rn(g, bs, 1), rn(g, bs, 24)
    out = {}
    for key, fn in (("K10_fwd", lambda: ba.rows_fwd_cuda(sq, sk, sv)),
                    ("K10_bwd", lambda: ba.rows_bwd_cuda(sq, sk, sv, g_den, g_so))):
        out[f"{key}_bits"] = bits_digest(fn())
        out[f"{key}_device_ms"] = graph_ms(fn, 10)
    del sq, sk, sv, g_den, g_so
    torch.cuda.empty_cache()
    return out


def yardsticks_only(torch, args) -> int:
    """K3 and K4, K5, K2, K6, K7, K10 and K12 of the imported package at the
    paths' shapes, one JSON line."""
    from hept_tpu_torch.ops import bucket_attn_cuda, cuda_lib, pair_ops, row_gather, sort

    secs = cuda_lib.build(("pair_ops", "row_gather", "bucket_attn", "sort"), force=True)
    smi = nvidia_smi_line()
    root = Path(hept_tpu_torch_root()).resolve()
    log(f"yardsticks of {root}: build {secs:.1f} s; card: {smi}")
    _, batch = make_batch(args.points, args.seed, 512)
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    idx = torch.as_tensor(batch["pairs"][0, 0]).to(DEVICE).contiguous()
    mask = torch.as_tensor(batch["pair_mask"][0]).to(DEVICE)
    k3 = k3_yardsticks(torch, pair_ops, idx, batch["x"].shape[1], gen)
    k4 = k4_yardsticks(torch, pair_ops, idx, mask, batch["x"].shape[1], gen)
    k5 = k5_yardsticks(torch, row_gather, gen)
    del idx, mask, batch
    torch.cuda.empty_cache()
    buckets = bucket_yardsticks(torch, bucket_attn_cuda, 60416, args.seed)
    k10 = k10_yardsticks(torch, bucket_attn_cuda, args.seed)
    k12 = k12_yardsticks(torch, sort, args.seed)
    log(json.dumps({"package": str(root), "card": smi, "K3": k3, "K4": k4, "K5": k5,
                    "K2_K6_K7": buckets, "K10": k10, "K12": k12}))
    return 0


def rel_l2(torch, a: dict, b: dict) -> float:
    """|a - b| / |b| over every tensor of two gradient (or update) dicts."""
    d2 = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in b)
    n2 = sum(float(b[k].double().pow(2).sum()) for k in b)
    return math.sqrt(d2 / max(n2, 1e-300))


def batch_loss_and_grads(torch, trainer, model, loss_fn, batch, mode: str):
    """Loss and parameter gradients of a batch of events through the
    trainer's `model_apply` (`mode`: "vmap" event by event, "flat" one
    forward), dropout off."""
    model.zero_grad(set_to_none=True)
    out = trainer.model_apply(model, batch, None, mode)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{mode} output not finite")
    loss = loss_fn(out, batch)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in
                                  model.named_parameters() if p.grad is not None}


def make_batch2(points: int, seeds, block_size: int):
    """Synthetic events of `points` points from each seed, packed as one
    batch (as `make_batch` packs one)."""
    import numpy as np

    from hept_tpu_torch.data.batching import pack_events, slab_friendly_n
    from hept_tpu_torch.data.synthetic import synthetic_tracking_event

    evs = [synthetic_tracking_event(np.random.default_rng(s), n_points=points,
                                    avg_track_size=8, pairs_per_point=16) for s in seeds]
    return evs, pack_events(evs, block_size=block_size,
                            n_max=slab_friendly_n(points, block_size), window_pairs=128)


def phase_flat(torch, trainer, batch2_np, steps: int, seed: int, zero_counts,
               read_counts) -> dict:
    """Flat batching (23): the hept_acc model on two 60k events as ONE
    forward of 2 x 60416 points (the batch index in the AND codes), and
    stacked (`sort_events` 2: each event its own row of the plan and the
    kernels). The first step, dropout off: flat against the event loop, flat
    with kernels against `plain_reference()`, stacked against the loop, at
    the bf16 levels (loss 1e-3, gradients 1e-2 relative L2). Then `steps`
    flat Adam steps at lr 1e-2 with dropout, launches counted (K1 / K2 4
    each a step on the tensor cores for the whole batch, K5 8, the loss's K3
    / K4 per event), one more under torch.profiler (device busy ms), peak
    GiB; beside them the same for the event loop (two single-event passes a
    step) and a one-event step."""
    from hept_tpu_torch.ops.dispatch import plain_reference
    from hept_tpu_torch.train.config import profile_config
    from hept_tpu_torch.utils.profiling import profile_device

    cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1, batch_mode="flat")
    batch = trainer.batch_to_device(batch2_np, DEVICE)
    in_dim, cd = batch2_np["x"].shape[2], batch2_np["coords"].shape[2]
    model = trainer.build_model(cfg, in_dim, cd, torch.Generator(device=DEVICE).manual_seed(seed),
                                DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    loss_fn = trainer.make_loss_fn(cfg)
    zero_counts()
    loss_f, grads_f = batch_loss_and_grads(torch, trainer, model, loss_fn, batch, "flat")
    first = read_counts()
    want = {"bucket_attn_fwd_tc": 4, "bucket_attn_bwd_tc": 4, "bucket_attn_fwd": 0,
            "bucket_attn_bwd": 0, **NO_K6_K7, "row_gather": 8,
            **{k: 2 * v for k, v in PAIR_LAUNCHES_STEP.items()}}
    bad = {k: (first[k], v) for k, v in want.items() if first[k] != v}
    if bad:
        raise AssertionError(f"flat: launches (got, want) {bad} in one step")
    loss_l, grads_l = batch_loss_and_grads(torch, trainer, model, loss_fn, batch, "vmap")
    with plain_reference():
        loss_p, grads_p = batch_loss_and_grads(torch, trainer, model, loss_fn, batch, "flat")
    log(f"phase flat: B=2 events of {batch2_np['valid'].sum(1).tolist()} points, n = 2 x "
        f"{batch2_np['x'].shape[1]}; first step loss flat {loss_f:.6f} loop {loss_l:.6f} "
        f"flat plain {loss_p:.6f}")
    check("flat vs loop loss |d|", abs(loss_f - loss_l), 1e-3 * abs(loss_l))
    check("flat vs loop gradient, relative L2", rel_l2(torch, grads_f, grads_l), 1e-2)
    check("flat kernels vs plain loss |d|", abs(loss_f - loss_p), 1e-3 * abs(loss_p))
    check("flat kernels vs plain gradient, relative L2", rel_l2(torch, grads_f, grads_p), 1e-2)
    del grads_p
    # stacked: the same model read as two plan rows
    cfg_s = profile_config("hept_acc", device=DEVICE, num_epochs=1, batch_mode="flat")
    cfg_s.model_kwargs["sort_events"] = 2
    stacked = trainer.build_model(cfg_s, in_dim, cd, None, DEVICE)
    stacked.load_state_dict(init_state)
    zero_counts()
    loss_s, grads_s = batch_loss_and_grads(torch, trainer, stacked, loss_fn, batch, "flat")
    st_launches = read_counts()
    for k in ("bucket_attn_fwd_tc", "bucket_attn_bwd_tc"):
        if st_launches[k] != 4:
            raise AssertionError(f"stacked: {k} launched {st_launches[k]}x, want 4")
    log(f"  stacked (sort_events 2) first step loss {loss_s:.6f}")
    check("stacked vs loop loss |d|", abs(loss_s - loss_l), 1e-3 * abs(loss_l))
    check("stacked vs loop gradient, relative L2", rel_l2(torch, grads_s, grads_l), 1e-2)
    del grads_s, grads_f, grads_l

    res = {"first_launches": first, "stacked_launches": st_launches}
    one_np = {k: v[:1] for k, v in batch2_np.items()}
    for label, mode, b, model in (
            ("flat", "flat", batch, model), ("stacked", "flat", batch, stacked),
            ("loop", "vmap", batch, model),
            ("one event", "vmap", trainer.batch_to_device(one_np, DEVICE), model)):
        model.load_state_dict(init_state)
        opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                     cfg.optimizer_kwargs["lr"])
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        step_ms, losses, launches, peak = timed_steps(
            torch, trainer, model, opt, loss_fn, b, gen, steps, f"{label} B={b['x'].shape[0]}",
            zero_counts, read_counts, batch_mode=mode)
        prof_ms, kernel_us, _ = profile_device(
            lambda: trainer.train_step(model, opt, loss_fn, b, gen, batch_mode=mode), 1)
        res[label] = {"step_ms": step_ms, "steady_ms": statistics.median(step_ms[1:]),
                      "busy_ms": sum(kernel_us.values()) / 1e3, "profiled_ms": prof_ms,
                      "peak_gib": peak, "launches": launches, "losses": losses}
        del opt
    per = {"flat": 1, "stacked": 1, "loop": 2, "one event": 1}
    for label, r in res.items():
        if label not in per:
            continue
        want = {"bucket_attn_fwd_tc": 4 * per[label] * steps,
                "bucket_attn_bwd_tc": 4 * per[label] * steps, "row_gather": 8 * per[label] * steps}
        bad = {k: (r["launches"][k], v) for k, v in want.items() if r["launches"][k] != v}
        if bad:
            raise AssertionError(f"{label}: launches (got, want) {bad} in {steps} steps")
    log("phase flat: hept_acc, " + "; ".join(
        f"{label}: step ms median {r['steady_ms']:.1f} (of {r['step_ms']}), device busy "
        f"{r['busy_ms']:.2f} ms (profiled step {r['profiled_ms']:.1f} ms), peak "
        f"{r['peak_gib']:.2f} GiB, losses {r['losses']}"
        for label, r in res.items() if label in per)
        + f"; flat launches {res['flat']['launches']}")
    del model, stacked, init_state, batch
    torch.cuda.empty_cache()
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dp_nccl(torch, trainer, batch_np, seed: int, steps: int = 3) -> dict:
    """DP at world 1 over NCCL (24): a one-rank process group on the card;
    `steps` hept_acc Adam steps (dropout on, the same generator seeds)
    through the trainer's `train_step` plain and with the data group, on
    two copies of one model: loss, gradient norm and every parameter after
    each step the same bits (the one-rank all-reduce returns its input).
    Step ms of each, interleaved."""
    import datetime

    import torch.distributed as dist

    from hept_tpu_torch.parallel.mesh import make_mesh
    from hept_tpu_torch.train.config import profile_config

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1, ("data",), device=DEVICE)
        cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1)
        batch = trainer.batch_to_device(batch_np, DEVICE)
        loss_fn = trainer.make_loss_fn(cfg)
        models, opts, gens = [], [], []
        for _ in range(2):
            models.append(trainer.build_model(
                cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE))
            opts.append(trainer.make_optimizer(models[-1].parameters(), cfg.optimizer_name,
                                               cfg.optimizer_kwargs["lr"]))
            gens.append(torch.Generator(device=DEVICE).manual_seed(seed + 1))
        ms = {"plain": [], "dp": []}
        for s in range(steps):
            ms_s, ms_out = {}, {}
            for label, i, group in (("plain", 0, None), ("dp", 1, mesh.group("data"))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(models[i], opts[i], loss_fn, batch, gens[i],
                                       data_group=group)
                ms_out[label] = (float(m["loss"]), float(m["grad_norm"]))
                torch.cuda.synchronize()
                ms_s[label] = (time.perf_counter() - t0) * 1e3
                ms[label].append(ms_s[label])
            if ms_out["plain"] != ms_out["dp"]:
                raise AssertionError(f"step {s}: DP (loss, grad_norm) {ms_out['dp']} != plain "
                                     f"{ms_out['plain']}")
            differ = [k for (k, a), b in zip(models[0].state_dict().items(),
                                             models[1].state_dict().values())
                      if not torch.equal(a, b)]
            if differ:
                raise AssertionError(f"step {s}: parameters differ after the DP step: {differ}")
            log(f"  step {s}: loss {ms_out['dp'][0]:.6f} the same bits; plain "
                f"{ms_s['plain']:.1f} ms, NCCL DP {ms_s['dp']:.1f} ms")
        res = {k: {"step_ms": v, "steady_ms": statistics.median(v[1:])} for k, v in ms.items()}
        log(f"phase dp nccl: world 1 over {mesh.backend}, {steps} hept_acc steps bit-equal to "
            f"the plain step (loss, grad_norm, every parameter); step ms median after the "
            f"first: plain {res['plain']['steady_ms']:.1f}, DP {res['dp']['steady_ms']:.1f}")
        del models, opts, batch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


# the dynamic-key share_heads model: the parity profile with the post-sort
# projections and one bucket grid per round shared by the heads, f32
SHARE_HEADS = {"qkv_post_sort": True, "shared_sort": True, "share_heads": True}
BUCKET_TRANSPORTS = ("replicated", "distributed")


def share_heads_config(**overrides):
    """The parity YAML with SHARE_HEADS (K6 f32 / K7 v1 at bs 100)."""
    from hept_tpu_torch.train.config import profile_config

    cfg = profile_config("hept", device=DEVICE, num_epochs=1, **overrides)
    cfg.model_kwargs.update(SHARE_HEADS)
    return cfg


def cols_launches(steps: int, k5: int = 8, fwd: str = "cols_fwd", bwd: str = "cols_bwd") -> dict:
    """The launches of `steps` tracking steps of a 4-layer dynamic-key model
    at bs 100 (parity, share_heads, the post-sort paths): K6 and K7 4 each a
    step (one a layer) on the counters `fwd` / `bwd` (f32 K6 and K7 v1 by
    default) and none on the other route, K5 `k5` a step (by default the
    unsort forward and backward a layer), the loss's K3 / K4."""
    return {**NO_K6_K7, **NO_K1_K2, fwd: 4 * steps, bwd: 4 * steps, "rows_fwd": 0,
            "rows_bwd": 0, "row_gather": k5 * steps,
            **{k: v * steps for k, v in PAIR_LAUNCHES_STEP.items()}}


def check_launches(label: str, got: dict, want: dict) -> None:
    bad = {k: (got.get(k, 0), v) for k, v in want.items() if got.get(k, 0) != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}")


def phase_share_heads(torch, trainer, batch_np, steps: int, seed: int, zero_counts,
                      read_counts) -> dict:
    """28. The dynamic-key share_heads model at full width (the parity YAML +
    qkv_post_sort, shared_sort, share_heads; f32) on the bs-100 event:
    `steps` Adam steps with dropout, each step's (loss, grad_norm) kept for
    phase 29, launches counted (`cols_launches`); one more step under
    torch.profiler (device busy ms); then the first step, dropout off, with
    kernels against `plain_reference()` on the kernel run's sort orders
    (`compare_first_step`'s f32 levels)."""
    run = dynamic_steps(torch, trainer, share_heads_config(), batch_np, steps, seed, zero_counts,
                        read_counts, "share_heads", cols_launches(steps))
    log(f"phase share_heads: {steps} steps (parity widths + qkv_post_sort / shared_sort / "
        f"share_heads, bs 100, 3 hashes, f32), median after the first {run['steady_ms']:.1f} "
        f"ms; profiled step {run['profiled_ms']:.1f} ms, device busy {run['busy_ms']:.2f} ms")
    return run


def phase_bucket_nccl(torch, trainer, batch_np, seed: int, ref: dict, zero_counts,
                      read_counts) -> dict:
    """29. The bucket train step at world 1 over NCCL (a one-rank ("data",
    "buckets") mesh), each transport: phase 28's steps from its initial
    weights and dropout seed through `make_bucket_train_step`; every step's
    (loss, grad_norm) and every parameter after the last step the same bits
    as phase 28's kernel steps (routing only moves values). Launches a step:
    K6 / K7 4 each; K5 8 with the replicated transport (the unsort), none
    with the distributed one (the payload moves by the route's indexing)."""
    import datetime

    import torch.distributed as dist

    from hept_tpu_torch.parallel.bp import make_bucket_model, make_bucket_train_step
    from hept_tpu_torch.parallel.mesh import make_mesh

    steps = len(ref["metrics"])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh(1, ("data", "buckets"), (1, 1), device=DEVICE)
        cfg = share_heads_config()
        tcfg = cfg.model_config(batch_np["x"].shape[2], batch_np["coords"].shape[2])
        batch = trainer.batch_to_device(batch_np, DEVICE)
        loss_fn = trainer.make_loss_fn(cfg)
        for transport in BUCKET_TRANSPORTS:
            model = make_bucket_model(tcfg, mesh, None, DEVICE, ref["init_state"], transport)
            opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                         cfg.optimizer_kwargs["lr"])
            step = make_bucket_train_step(model, opt, loss_fn, mesh, seed=seed + 1)
            torch.cuda.synchronize()
            zero_counts()
            step_ms, metrics = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                m = step(batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts()
            check_launches(f"bucket {transport}", launches, cols_launches(
                steps, 8 if transport == "replicated" else 0))
            if metrics != ref["metrics"]:
                raise AssertionError(f"bucket {transport}: (loss, grad_norm) by step {metrics} "
                                     f"!= phase 28's {ref['metrics']}")
            differ = [k for k, v in model.state_dict().items()
                      if not torch.equal(v, ref["final_state"][k])]
            if differ:
                raise AssertionError(f"bucket {transport}: parameters differ from phase 28's "
                                     f"after {steps} steps: {differ}")
            res[transport] = {"step_ms": step_ms, "launches": launches,
                              "steady_ms": statistics.median(step_ms[1:])}
            log(f"phase bucket nccl {transport}: world 1 over {mesh.backend}, {steps} steps "
                f"bit-equal to phase 28 (loss, grad_norm each step, every parameter); step ms "
                f"{step_ms}; launches {launches}")
            del model, opt, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


RANK_TIMEOUT_S = 600


def spawn_ranks(world: int, inputs: dict) -> list:
    """`world` processes of this script (`--rank-worker`) sharing the card
    in a gloo group (NCCL refuses two ranks on one device), each running
    the two-rank phases on `inputs`; their outputs by rank. A rank that
    fails or does not end within RANK_TIMEOUT_S fails the phase (the others
    are killed)."""
    import torch

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    torch.save(inputs, d / "inputs.pt")
    logs = [open(d / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank-worker",
                               str(d), "--rank", str(r), "--world", str(world)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank did not end within {RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        for r in range(world):
            for line in (d / f"log_{r}.txt").read_text().splitlines():
                log(f"  [rank {r}] {line}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed (exit codes "
                             f"{[procs[r].returncode for r in bad]})")
    return [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(world)]


def rank_worker(torch, args) -> int:
    """One rank of the two-rank phases (`spawn_ranks`): DP (an event a rank,
    hept_acc), head-TP (the parity profile, its heads split over the ranks)
    and the head-sharded core (K10); or, given phase 37's inputs, that
    phase's arms (`rank_sharded`). Each task runs twice: the first call's
    launches and results go to the main process to check, and both calls'
    ms (the first in a fresh process includes library and communicator
    set-up)."""
    import datetime

    import torch.distributed as dist

    from hept_tpu_torch.ops import bucket_attn_cuda, pair_ops, row_gather
    from hept_tpu_torch.parallel import tp
    from hept_tpu_torch.parallel.dp import shard_batch, train_step
    from hept_tpu_torch.parallel.mesh import TP_AXES, make_mesh
    from hept_tpu_torch.parallel.sp import head_sharded_attention
    from hept_tpu_torch.train import trainer
    from hept_tpu_torch.train.config import profile_config

    d, rank, world = Path(args.rank_worker), args.rank, args.world
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    inp = torch.load(d / "inputs.pt", weights_only=False)
    counters = (bucket_attn_cuda.LAUNCHES, pair_ops.LAUNCHES, row_gather.LAUNCHES)

    def counted(label: str, fn, read) -> dict:
        ms = []
        for i in range(2):
            torch.cuda.synchronize()
            dist.barrier()
            for c in counters:
                for k in c:
                    c[k] = 0
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first = {**read(res), "launches": {k: v for c in counters
                                                   for k, v in c.items() if v}}
        print(f"{label}: ms first / warm {ms[0]:.1f} / {ms[1]:.1f}, launches "
              f"{first['launches']}", flush=True)
        return {**first, "ms": ms}

    def cpu(tensors: dict) -> dict:
        return {k: v.detach().cpu().clone() for k, v in tensors.items()}

    if "phase37" in inp:
        out = rank_sharded(torch, trainer, inp["phase37"], world, counted, cpu)
        torch.save(out, d / f"out_{rank}.pt")
        dist.destroy_process_group()
        return 0
    out = {}
    # DP: an event a rank, Adam steps, dropout off
    cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1)
    mesh = make_mesh(world, ("data",), device=DEVICE)
    b = trainer.batch_to_device(shard_batch(inp["dp_batch"], rank, world), DEVICE)
    model = trainer.build_model(cfg, b["x"].shape[2], b["coords"].shape[2], None, DEVICE)
    model.load_state_dict(inp["dp_state"])
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    loss_fn = trainer.make_loss_fn(cfg)
    out["dp"] = counted(
        "dp", lambda: trainer.train_step(model, opt, loss_fn, b, None,
                                         data_group=mesh.group("data")),
        lambda m: {"loss": float(m["loss"]),
                   "grads": cpu({k: p.grad for k, p in model.named_parameters()}),
                   "params": cpu(model.state_dict())})
    del model, opt, b
    # TP: the parity profile, heads over the ranks, on the reference's
    # permutations (this rank's heads), Adam steps through dp.train_step
    cfg = profile_config("hept", device=DEVICE, num_epochs=1, shard_heads=world)
    mesh = make_mesh(world, TP_AXES, (1, 1, world), device=DEVICE)
    b = trainer.batch_to_device(inp["tp_batch"], DEVICE)
    model = tp.make_tp_model(cfg.model_config(b["x"].shape[2], b["coords"].shape[2]), mesh,
                             None, DEVICE, state_dict=inp["tp_state"])
    w = model.cfg.num_heads
    perms = [tuple(p[:, rank * w:(rank + 1) * w].to(DEVICE) for p in pr)
             for pr in inp["tp_perms"]]
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])

    def apply(m_, b_, g_):
        return m_(b_["x"][0], b_["coords"][0], b_["valid"][0], g_, perms=perms)[None]

    out["tp"] = counted(
        "tp", lambda: train_step(model, opt, trainer.make_loss_fn(cfg), apply, b,
                                 mesh.group("data"), None,
                                 sharded_norm=tp.sharded_global_norm(mesh)),
        lambda m: {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "grads": cpu(tp.gather_state_dict(
                       {k: p.grad for k, p in model.named_parameters()}, mesh))})
    del model, opt, b
    # SP: the head-sharded core on the reference's permutations
    mesh = make_mesh(world, ("heads",), device=DEVICE)
    sp = {k: v.to(DEVICE) if torch.is_tensor(v) else v for k, v in inp["sp"].items()}
    ins = [sp[k].requires_grad_(True) for k in ("q", "k", "v")]

    def sp_run():
        o = head_sharded_attention(*ins, sp["alpha"], sp["codes"], sp["invalid"],
                                   mesh.group("heads"), block_size=sp["block_size"],
                                   impl="pallas", perms=tuple(p.to(DEVICE) for p in sp["perms"]))
        return o, torch.autograd.grad((o * sp["cot"]).sum(), ins)

    out["sp"] = counted("sp", sp_run, lambda r: {"out": r[0].detach().cpu(),
                                                 "grads": [g.cpu() for g in r[1]]})
    del ins, sp
    out.update(rank_bucket(torch, trainer, inp["bucket"], world, counted, cpu))
    torch.save(out, d / f"out_{rank}.pt")
    dist.destroy_process_group()
    return 0


def rank_bucket(torch, trainer, inp: dict, world: int, counted, cpu) -> dict:
    """30 on one rank of `rank_worker`: the bucket-sharded core over the
    ranks, each transport (forward, the six input gradients, the sort
    orders it took), the overflow case (cap_factor 1e-6), then one
    `make_bucket_train_step` step per transport of the share_heads model on
    a ("data", "buckets") = (1, world) mesh, dropout off, on the
    single-process run's sort orders."""
    from hept_tpu_torch.parallel.bp import (
        bucket_sharded_core,
        make_bucket_model,
        make_bucket_train_step,
    )
    from hept_tpu_torch.parallel.mesh import make_mesh

    out = {}
    core = {k: v.to(DEVICE) if torch.is_tensor(v) else v for k, v in inp["core"].items()}
    group = make_mesh(world, ("buckets",), device=DEVICE).group("buckets")
    names = ("x", "coords", "wq", "wk", "wv", "sqrt_w")
    for label, transport, cap in (("replicated", "replicated", 2.0),
                                  ("distributed", "distributed", 2.0),
                                  ("overflow", "distributed", 1e-6)):
        ins = [core[k].clone().requires_grad_(True) for k in names]

        def run():
            seen = []
            o = bucket_sharded_core(*ins, core["alpha"], core["codes"], core["invalid"], group,
                                    block_size=core["block_size"], transport=transport,
                                    cap_factor=cap, record_perms=seen)
            return o, torch.autograd.grad((o * core["cot"]).sum(), ins), seen[0]

        out[f"bucket_core_{label}"] = counted(
            f"bucket core {label}", run,
            lambda r: {"out": r[0].detach().cpu(), "grads": [g.cpu() for g in r[1]],
                       "src": r[2].cpu()})
    mesh = make_mesh(world, ("data", "buckets"), (1, world), device=DEVICE)
    cfg = share_heads_config()
    b = trainer.batch_to_device(inp["batch"], DEVICE)
    tcfg = cfg.model_config(b["x"].shape[2], b["coords"].shape[2])
    perms = [p_.to(DEVICE) for p_ in inp["perms"]]

    def apply(m_, b_, g_):
        return m_(b_["x"][0], b_["coords"][0], b_["valid"][0], g_, perms=perms)[None]

    for transport in BUCKET_TRANSPORTS:
        model = make_bucket_model(tcfg, mesh, None, DEVICE, inp["state"], transport)
        opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                     cfg.optimizer_kwargs["lr"])
        step = make_bucket_train_step(model, opt, trainer.make_loss_fn(cfg), mesh,
                                      apply_fn=apply)
        out[f"bucket_step_{transport}"] = counted(
            f"bucket step {transport}", lambda: step(b),
            lambda m: {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "grads": cpu({k: p.grad for k, p in model.named_parameters()})})
        del model, opt, step
    return out


def bucket_reference(torch, trainer, batch_np, seed: int, state: dict) -> tuple[dict, dict]:
    """30's single-process references and the ranks' inputs: layer 0's
    operands of the share_heads model (phase 28's initial weights) through
    `hept_attention_core_xcols` without a plan (forward, the gradients of
    x, coords, wq, wk, wv, sqrt_w through a fixed random cotangent, the sort
    orders), and the model's loss and gradients, dropout off, with each
    layer's sort orders recorded."""
    from hept_tpu_torch.models.transformer import prepare_event
    from hept_tpu_torch.ops.bucket_attn import hept_attention_core_xcols

    cfg = share_heads_config()
    bs = cfg.model_kwargs["block_size"]
    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2], None,
                                DEVICE)
    model.load_state_dict(state)
    blk = model.blocks[0]
    with torch.no_grad():
        x, coords, codes, invalid = prepare_event(batch["x"][0], batch["coords"][0],
                                                  batch["valid"][0], model.regions, bs)
        xn = blk.norm1(model.feat_enc_1(torch.relu(model.feat_enc_0(x))))
        core = {"x": xn.t().contiguous(), "coords": coords.t().contiguous(),
                "wq": blk._heads(blk.w_q), "wk": blk._heads(blk.w_k), "wv": blk._heads(blk.w_v),
                "sqrt_w": blk.attn._sqrt_w(blk.w_rpe)}
        core = {k: v.detach().contiguous() for k, v in core.items()}
    ins = [v.clone().requires_grad_(True) for v in core.values()]
    h, _, d = core["wq"].shape
    cot = torch.randn((x.shape[0], h * d), device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(seed))
    alpha = blk.attn.e2lsh_alpha.detach()
    seen = []
    out = hept_attention_core_xcols(*ins, alpha, codes, invalid, None, block_size=bs,
                                    impl="pallas", share_heads=True, unsort_rows=False,
                                    record_perms=seen)
    grads = torch.autograd.grad((out * cot).sum(), ins)
    ref = {"core": {"out": out.detach(), "grads": grads, "src": seen[0]}}
    perms = []
    loss, mgrads = loss_and_grads(torch, model, trainer.make_loss_fn(cfg), batch,
                                  record_perms=perms)
    ref["step"] = {"loss": loss, "grads": mgrads}
    inputs = {"core": {**{k: v.cpu() for k, v in core.items()}, "alpha": alpha.cpu(),
                       "codes": codes.cpu(), "invalid": invalid.cpu(), "cot": cot.cpu(),
                       "block_size": bs},
              "state": state, "batch": batch_np, "perms": [p_.cpu() for p_ in perms],
              "buckets_per_rank": x.shape[0] // bs // 2}
    del model, batch, out, ins
    torch.cuda.empty_cache()
    return inputs, ref


def check_bucket_ranks(torch, outs: list, ref: dict, n_buckets: int) -> None:
    """30's checks on the ranks' results: each transport's core output to
    1e-5 and input gradients to 1e-4 of scale against the single process,
    on the same sort orders (the ranks' own keys must give them); the
    overflow case NaN everywhere; each transport's train step: loss rtol
    1e-5, every parameter gradient 1e-4 of its scale (floored at 1e-3 of the
    largest) against the single process; K6 f32 / K7 v1 one launch a layer
    a rank (one each a core call, 4 each a step), K5 only with the
    replicated transport."""
    r = ref["core"]
    for rank, o in enumerate(outs):
        for label in BUCKET_TRANSPORTS:
            res = o[f"bucket_core_{label}"]
            check_launches(f"bucket core {label} rank {rank}", res["launches"],
                           {"cols_fwd": 1, "cols_bwd": 1, "row_gather":
                            2 if label == "replicated" else 0})
            if not torch.equal(res["src"].to(DEVICE), r["src"]):
                raise AssertionError(f"bucket core {label} rank {rank}: its keys sorted "
                                     "otherwise than the single process's")
            check(f"bucket core {label} rank {rank} output max|d|",
                  max_err(res["out"].to(DEVICE), r["out"]), 1e-5 * scale(r["out"]))
            for nm, a, b in zip(("x", "coords", "wq", "wk", "wv", "sqrt_w"), res["grads"],
                                r["grads"]):
                check(f"bucket core {label} rank {rank} d{nm} max|d|", max_err(a.to(DEVICE), b),
                      1e-4 * scale(b))
        if not torch.isnan(o["bucket_core_overflow"]["out"]).all():
            raise AssertionError(f"bucket core overflow rank {rank}: output not all NaN")
    r = ref["step"]
    floor = 1e-3 * max(scale(g) for g in r["grads"].values())
    for rank, o in enumerate(outs):
        for transport in BUCKET_TRANSPORTS:
            res = o[f"bucket_step_{transport}"]
            check_launches(f"bucket step {transport} rank {rank}", res["launches"],
                           {"cols_fwd": 4, "cols_bwd": 4, "cols_fwd_tc": 0, "cols_bwd_tc": 0,
                            "row_gather": 8 if transport == "replicated" else 0})
            check(f"bucket step {transport} rank {rank} loss |d| / |loss|",
                  abs(res["loss"] - r["loss"]) / abs(r["loss"]), 1e-5)
            ratios = {k: max_err(res["grads"][k].to(DEVICE), g) / max(scale(g), floor)
                      for k, g in r["grads"].items()}
            worst = max(ratios, key=ratios.get)
            check(f"bucket step {transport} rank {rank}: all {len(ratios)} parameter gradients, "
                  f"worst {worst}", ratios[worst], 1e-4)
    log(f"phase bucket two ranks: share_heads, bucket shards 2 ({n_buckets} buckets of 100 a "
        "round and head a rank); ms by rank (first, warm): " + "; ".join(
            f"{k[7:]} {[[round(x, 1) for x in o[k]['ms']] for o in outs]}"
            for k in outs[0] if k.startswith("bucket_"))
        + f"; step launches a rank {outs[0]['bucket_step_replicated']['launches']} "
          f"(replicated), {outs[0]['bucket_step_distributed']['launches']} (distributed)")


def phase_two_ranks(torch, trainer, batch2_np, batch100_np, seed: int, share: dict) -> dict:
    """The two-rank phases (25-27) on one card: the references here, the
    ranks in `spawn_ranks`. 25 DP: hept_acc, an event a rank, one Adam step
    (dropout off) against the single-process step of both events: loss
    1e-3, the averaged gradient 1e-2 relative L2 (bf16 levels), the updated
    parameters 1e-2 relative L2 of the update; K1 / K2 4 each a rank. 26 TP:
    the parity profile with shard_heads 2 (4 heads a rank) on the bs-100
    event, the reference's permutations: loss 1e-4, each parameter's
    gradient 1e-3 of its scale (floored at 1e-3 of the largest, as phase 4);
    K6 f32 and K7 v1 4 each a rank. 27 SP: `head_sharded_attention` at the
    parity width on 14400 buckets of 100 against the unsharded core (K10)
    on the same permutations: output 1e-5, input gradients 1e-4 of scale;
    K10 one each way a rank."""
    from hept_tpu_torch.models.transformer import prepare_event
    from hept_tpu_torch.ops.bucket_attn import hept_attention_core
    from hept_tpu_torch.train.config import profile_config

    inputs, ref = {}, {}
    # 25. DP reference: both events, one Adam step, dropout off
    cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1)
    batch = trainer.batch_to_device(batch2_np, DEVICE)
    model = trainer.build_model(cfg, batch2_np["x"].shape[2], batch2_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    inputs["dp_state"] = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    inputs["dp_batch"] = batch2_np
    before = copy.deepcopy(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg), batch, None)
    ref["dp"] = {"loss": float(m["loss"]),
                 "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                 "update": {k: v - before[k] for k, v in model.state_dict().items()}}
    del model, opt, batch
    # 26. TP reference: the parity step on one event, its permutations recorded
    cfg = profile_config("hept", device=DEVICE, num_epochs=1)
    batch = trainer.batch_to_device(batch100_np, DEVICE)
    model = trainer.build_model(cfg, batch100_np["x"].shape[2], batch100_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    inputs["tp_state"] = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    inputs["tp_batch"] = batch100_np
    perms = []
    loss, grads = loss_and_grads(torch, model, trainer.make_loss_fn(cfg), batch,
                                 record_perms=perms)
    inputs["tp_perms"] = [tuple(p.cpu() for p in pr) for pr in perms]
    ref["tp"] = {"loss": loss, "grads": grads}
    # 27. SP reference: layer 0's q_hat / k_hat / v of that model, as phase 9
    blk, bs = model.blocks[0], cfg.model_kwargs["block_size"]
    with torch.no_grad():
        x, coords, codes, invalid = prepare_event(batch["x"][0], batch["coords"][0],
                                                  batch["valid"][0], model.regions, bs)
        xn = blk.norm1(model.feat_enc_1(torch.relu(model.feat_enc_0(x))))
        cols = blk.attn.prep_qkv(blk.w_q(xn), blk.w_k(xn), blk.w_v(xn), coords, invalid,
                                 blk.w_rpe)
    ins = [c_.transpose(1, 2).contiguous().requires_grad_(True) for c_ in cols]
    alpha = blk.attn.e2lsh_alpha.detach()
    cot = torch.randn(ins[2].shape, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                      device=DEVICE)
    sperms = []
    out = hept_attention_core(*ins, alpha, codes, invalid, block_size=bs, impl="pallas",
                              record_perms=sperms)
    sgrads = torch.autograd.grad((out * cot).sum(), ins)
    ref["sp"] = {"out": out.detach(), "grads": sgrads}
    inputs["sp"] = {"q": ins[0].detach().cpu(), "k": ins[1].detach().cpu(),
                    "v": ins[2].detach().cpu(), "alpha": alpha.cpu(), "codes": codes.cpu(),
                    "invalid": invalid.cpu(), "cot": cot.cpu(), "block_size": bs,
                    "perms": tuple(p.cpu() for p in sperms[0])}
    n_buckets = sperms[0][0].shape[0] * ins[0].shape[0] * (ins[0].shape[1] // bs)
    del model, batch, x, xn, cols, ins, out
    torch.cuda.empty_cache()
    inputs["bucket"], ref["bucket"] = bucket_reference(torch, trainer, batch100_np, seed,
                                                       share["init_state"])

    t0 = time.perf_counter()
    outs = spawn_ranks(2, inputs)
    log(f"phase two ranks: 2 processes on the card (gloo), {time.perf_counter() - t0:.1f} s "
        "wall including their start")
    # 25. DP
    r = ref["dp"]
    for rank, o in enumerate(outs):
        dp = o["dp"]
        want = {"bucket_attn_fwd_tc": 4, "bucket_attn_bwd_tc": 4, "row_gather": 8}
        bad = {k: (dp["launches"].get(k, 0), v) for k, v in want.items()
               if dp["launches"].get(k, 0) != v}
        if bad or dp["launches"].get("cols_fwd") or dp["launches"].get("bucket_attn_fwd"):
            raise AssertionError(f"dp rank {rank}: launches {dp['launches']}, want {want}")
        check(f"dp rank {rank} loss vs the single-process two-event step |d|",
              abs(dp["loss"] - r["loss"]), 1e-3 * abs(r["loss"]))
        g = {k: v.to(DEVICE) for k, v in dp["grads"].items()}
        check(f"dp rank {rank} averaged gradient, relative L2", rel_l2(torch, g, r["grads"]),
              1e-2)
        upd = {k: dp["params"][k].to(DEVICE) - inputs["dp_state"][k].to(DEVICE)
               for k in r["update"]}
        check(f"dp rank {rank} parameter update, relative L2", rel_l2(torch, upd, r["update"]),
              1e-2)
    log(f"phase dp two ranks: hept_acc, an event a rank, one Adam step; ms by rank (first, "
        f"warm) {[[round(x, 1) for x in o['dp']['ms']] for o in outs]}; launches a rank "
        f"{outs[0]['dp']['launches']}")
    # 26. TP
    r = ref["tp"]
    t = outs[0]["tp"]
    for rank, o in enumerate(outs):
        ln = o["tp"]["launches"]
        if ln.get("cols_fwd") != 4 or ln.get("cols_bwd") != 4 or ln.get("cols_fwd_tc") \
                or ln.get("bucket_attn_fwd_tc") or ln.get("rows_fwd"):
            raise AssertionError(f"tp rank {rank}: launches {ln}, want cols_fwd 4, cols_bwd 4")
    check("tp loss vs the single-process step |d|", abs(t["loss"] - r["loss"]),
          1e-4 * abs(r["loss"]))
    floor = 1e-3 * max(scale(gg) for gg in r["grads"].values())
    ratios = {k: max_err(t["grads"][k].to(DEVICE), r["grads"][k]) / max(scale(r["grads"][k]),
                                                                       floor)
              for k in r["grads"]}
    worst = max(ratios, key=ratios.get)
    check(f"tp all {len(ratios)} parameter gradients vs single-process, worst {worst}",
          ratios[worst], 1e-3)
    log(f"phase tp two ranks: parity hept, shard_heads 2 (4 heads a rank); ms by rank (first, "
        f"warm) {[[round(x, 1) for x in o['tp']['ms']] for o in outs]}; launches a rank "
        f"{t['launches']}")
    # 27. SP
    r = ref["sp"]
    for rank, o in enumerate(outs):
        sp = o["sp"]
        if sp["launches"].get("rows_fwd") != 1 or sp["launches"].get("rows_bwd") != 1:
            raise AssertionError(f"sp rank {rank}: launches {sp['launches']}, want K10 1 + 1")
        check(f"sp rank {rank} output max|d|", max_err(sp["out"].to(DEVICE), r["out"]),
              1e-5 * scale(r["out"]))
        for nm, a, b in zip(("q_hat", "k_hat", "v"), sp["grads"], r["grads"]):
            check(f"sp rank {rank} d{nm} max|d|", max_err(a.to(DEVICE), b), 1e-4 * scale(b))
    log(f"phase sp two ranks: head_sharded_attention, {n_buckets} buckets of 100 (f32), 4 "
        f"heads a rank; ms by rank (first, warm) "
        f"{[[round(x, 1) for x in o['sp']['ms']] for o in outs]}; launches a rank "
        f"{outs[0]['sp']['launches']}")
    # 30. the bucket-axis SP
    check_bucket_ranks(torch, outs, ref["bucket"], inputs["bucket"]["buckets_per_rank"])
    keys = [k for k in outs[0] if k not in ("dp", "tp", "sp")] + ["dp", "tp", "sp"]
    return {k: [o[k]["launches"] for o in outs] for k in keys} | {
        "ms": {k: [o[k]["ms"] for o in outs] for k in keys}}


def reference_graph(rng, n: int, evtid: int) -> dict:
    """One tracking event in the reference's processed (PyG) layout: 14
    features, (eta, phi), layer, particle id (noise 0), reconstructability,
    pt, evtid and the supervision pairs within each particle."""
    import numpy as np

    pid = rng.integers(0, max(2, n // 6), n)
    pid[:n // 20] = 0
    src, dst = [], []
    for p_ in np.unique(pid[pid > 0]):
        idx = np.nonzero(pid == p_)[0]
        a, b = np.meshgrid(idx, idx)
        keep = a != b
        src.append(a[keep])
        dst.append(b[keep])
    return dict(x=rng.standard_normal((n, 14)).astype(np.float32),
                pos=rng.standard_normal((n, 2)).astype(np.float32),
                layer=rng.integers(0, 10, n), particle_id=pid,
                reconstructable=rng.integers(0, 2, n), pt=rng.uniform(0.1, 3.0, n),
                evtid=np.array([evtid]),
                point_pairs_index_rad=np.stack([np.concatenate(src), np.concatenate(dst)]))


def phase_reference_data(torch, trainer, seed: int, zero_counts, read_counts) -> dict:
    """31. A reference-layout `data.pt` (10 events of 2000 points, pickled as
    PyG's `Data`) written on the host and read back through `get_dataset`
    (`data/loaders.py`): the reference's split and every event's pairs in
    range; one parity step (dropout off) on the card on its first test event, K6 / K7
    v1 4 each and K5 8, a finite loss. Then `scripts/hept_example.py` at a
    small size on the card (2000 points, 3 events, 2 epochs): finite losses
    and retrieval metrics in [0, 1]."""
    import numpy as np

    from hept_tpu_torch.data.batching import pack_events
    from hept_tpu_torch.data.datasets import get_dataset
    from hept_tpu_torch.data.loaders import save_reference_dataset
    from hept_tpu_torch.scripts import hept_example
    from hept_tpu_torch.train.config import profile_config

    rng = np.random.default_rng(seed)
    d = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    t0 = time.perf_counter()
    save_reference_dataset([reference_graph(rng, 2000, 100 + i) for i in range(10)],
                           "tracking-6k", d, ("point_pairs_index_rad",))
    ds = get_dataset("tracking-6k", data_dir=d)
    load_s = time.perf_counter() - t0
    events = ds.train + ds.valid + ds.test
    # the reference's split of 10 events: 80 % rounded down to a multiple of
    # 10 trains (none), 10 % validates, the rest tests
    if (len(ds.train), len(ds.valid), len(ds.test)) != (0, 1, 9) or (ds.in_dim, ds.coords_dim) \
            != (15, 6) or not all(0 <= ev.pairs.min() and ev.pairs.max() < ev.n for ev in events):
        raise AssertionError(f"reference archive read back wrong: splits {len(ds.train)} / "
                             f"{len(ds.valid)} / {len(ds.test)}, dims {ds.in_dim} / "
                             f"{ds.coords_dim}")
    cfg = profile_config("hept", device=DEVICE, num_epochs=1)
    batch = trainer.batch_to_device(pack_events(ds.test[:1], block_size=100,
                                                window_pairs=128), DEVICE)
    model = trainer.build_model(cfg, ds.in_dim, ds.coords_dim,
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    zero_counts()
    loss = float(trainer.train_step(model, opt, trainer.make_loss_fn(cfg), batch)["loss"])
    launches = read_counts()
    check_launches("reference-data parity step", launches, cols_launches(1))
    if not math.isfinite(loss):
        raise AssertionError(f"reference-data parity step: loss {loss}")
    log(f"phase reference data: 10 events of 2000 points written in the reference's layout "
        f"and read through get_dataset in {load_s:.2f} s; one parity step on the test event "
        f"(n = {batch['x'].shape[1]}): loss {loss:.6f}, launches {launches}")
    del model, opt, batch
    t0 = time.perf_counter()
    res = hept_example.main(["--device", DEVICE, "--points", "2000", "--events", "3",
                             "--epochs", "2"])
    if not (all(math.isfinite(x) for x in res["losses"])
            and all(0.0 <= res[k] <= 1.0 for k in ("accuracy", "precision", "recall"))):
        raise AssertionError(f"hept_example: {res}")
    log(f"phase example: hept_example at 2000 points, 3 events, 2 epochs on the card in "
        f"{time.perf_counter() - t0:.1f} s: losses {res['losses']}, accuracy@0.9 "
        f"{res['accuracy']:.4f}, inference {res['inference_ms']:.2f} ms / event")
    torch.cuda.empty_cache()
    return {"launches": launches, "example": res}


def dynamic_config(profile: str = "hept", overrides: dict | None = None, **model_kwargs):
    """A shipped profile (default the parity YAML: bs 100, f32) with
    `model_kwargs` over its model kwargs and `overrides` over its top-level
    keys (padding_mode)."""
    from hept_tpu_torch.train.config import profile_config

    cfg = profile_config(profile, device=DEVICE, num_epochs=1, **(overrides or {}))
    cfg.model_kwargs.update(model_kwargs)
    return cfg


def dynamic_steps(torch, trainer, cfg, batch_np, steps: int, seed: int, zero_counts,
                  read_counts, label: str, want: dict, profile: bool = True,
                  compare: bool = True) -> dict:
    """`steps` Adam steps with dropout of the model of `cfg` (weights and
    dropout from the seed), each step's (loss, grad_norm) and the
    parameters after them kept for bit comparisons, launches counted (each
    counter of `want` must read its value); optionally one more step under
    torch.profiler (device busy ms) and the first step with kernels against
    `plain_reference()` on the kernel run's sort orders
    (`compare_first_step`). Returns the initial and final parameters too."""
    from hept_tpu_torch.utils.profiling import profile_device

    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs.get("lr", 1e-3))
    loss_fn = trainer.make_loss_fn(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = trainer.train_step(model, opt, loss_fn, batch, gen)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    check_launches(label, launches, want)
    if not all(math.isfinite(x) for pair in metrics for x in pair):
        raise AssertionError(f"{label}: non-finite step metrics {metrics}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    final_state = copy.deepcopy(model.state_dict())
    busy = prof_ms = None
    kernel_us = {}
    if profile:
        prof_ms, kernel_us, _ = profile_device(
            lambda: trainer.train_step(model, opt, loss_fn, batch, gen), 1)
        busy = sum(kernel_us.values()) / 1e3
    steady = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
    log(f"  {label}: {steps} steps, (loss, grad_norm) {metrics}; step ms {step_ms}, median "
        f"after the first {steady:.1f}" + ("" if busy is None else
                                          f"; profiled step {prof_ms:.1f} ms, busy {busy:.2f}")
        + f"; launches {{{', '.join(f'{k}: {launches[k]}' for k in want if want[k])}}}; "
        f"peak {peak:.2f} GiB")
    del opt
    if compare:
        model.load_state_dict(init_state)
        compare_first_step(torch, label, cfg, model, loss_fn, batch)
    del model
    torch.cuda.empty_cache()
    return {"init_state": init_state, "metrics": metrics, "final_state": final_state,
            "launches": launches, "step_ms": step_ms, "steady_ms": steady, "busy_ms": busy,
            "profiled_ms": prof_ms, "peak_gib": peak, "kernel_us": kernel_us}


def same_run(torch, label: str, a: dict, b: dict) -> None:
    """Two runs of `dynamic_steps` gave the same bits: every step's loss
    and gradient norm, every parameter after the last step."""
    if a["metrics"] != b["metrics"]:
        raise AssertionError(f"{label}: step metrics {b['metrics']} != {a['metrics']}")
    bad = [k for k, v in a["final_state"].items() if not torch.equal(v, b["final_state"][k])]
    if bad:
        raise AssertionError(f"{label}: parameters differ after the steps: {bad[:5]}")
    log(f"  {label}: the same bits (loss, grad_norm of each step, every parameter)")


def phase_zero_padding(torch, trainer, batch100_np, batch512_np, steps: int, seed: int,
                       zero_counts, read_counts) -> dict:
    """32. Zero padding (the reference's src variant): the parity YAML with
    padding_mode zero, `steps` steps at full width (K6 f32 / K7 v1 4 each,
    K5 8 a step), busy ms, the first step with kernels against plain at
    phase 7's f32 gates; then one hept_acc step (bs 512, static plan) with
    padding_mode zero (K1 / K2 on the tensor cores 4 each, K5 8) and its
    first step against plain at phase 4's bf16 gates."""
    zero = {"padding_mode": "zero"}
    parity = dynamic_steps(torch, trainer, dynamic_config(overrides=zero), batch100_np, steps,
                           seed, zero_counts, read_counts, "zero-padded parity",
                           cols_launches(steps, 8))
    acc_want = {"bucket_attn_fwd_tc": 4, "bucket_attn_bwd_tc": 4, "bucket_attn_fwd": 0,
                "bucket_attn_bwd": 0, **NO_K6_K7, "row_gather": 8,
                **PAIR_LAUNCHES_STEP}
    acc = dynamic_steps(torch, trainer, dynamic_config("hept_acc", overrides=zero),
                        batch512_np, 1, seed, zero_counts, read_counts, "zero-padded hept_acc",
                        acc_want, profile=False)
    return {"parity": parity, "hept_acc": acc}


def phase_post_sort(torch, trainer, batch100_np, steps: int, seed: int, zero_counts,
                    read_counts, share: dict) -> dict:
    """33. Per-head dynamic keys after the sort (the parity YAML +
    qkv_post_sort) and with shared_sort, f32: `steps` steps each (K6 / K7
    v1 4 each, K5 8 a step), busy ms, the first step against plain at phase
    7's gates. The gather_sort twin of each and of phase 28's share_heads
    model: the same bits as its sort-carry run, K5 a step 24 (per-head:
    q's and k's [x | coords] gathers forward and backward, and the unsort's,
    each layer), 16 (shared_sort, share_heads). Phase 28's model with
    fold_unsort, which runs the head-broadcast carry: phase 28's bits (K5 8
    a step)."""
    out = {}
    for label, kw, k5 in (("per-head post-sort", {"qkv_post_sort": True}, 24),
                          ("shared_sort", {"qkv_post_sort": True, "shared_sort": True}, 16)):
        out[label] = dynamic_steps(torch, trainer, dynamic_config(**kw), batch100_np, steps,
                                   seed, zero_counts, read_counts, label,
                                   cols_launches(steps, 8))
        out[label + " gather_sort"] = dynamic_steps(
            torch, trainer, dynamic_config(**kw, gather_sort=True), batch100_np, steps, seed,
            zero_counts, read_counts, label + " gather_sort", cols_launches(steps, k5),
            profile=False, compare=False)
        same_run(torch, f"{label} gather_sort vs sort-carry", out[label],
                 out[label + " gather_sort"])
    ref = {"metrics": share["metrics"], "final_state": share["final_state"]}
    for label, kw, k5 in (("share_heads gather_sort", {"gather_sort": True}, 16),
                          ("share_heads fold_unsort", {"fold_unsort": True}, 8)):
        out[label] = dynamic_steps(torch, trainer, dynamic_config(**SHARE_HEADS, **kw),
                                   batch100_np, steps,
                                   seed, zero_counts, read_counts, label,
                                   cols_launches(steps, k5), profile=False, compare=False)
        same_run(torch, f"{label} vs phase 28", ref, out[label])
    return out


def bf16_gradient_check(torch, trainer, cfg, batch_np, seed: int) -> dict:
    """The bf16-gradient contract at the model level: the model's
    gradients (K6 bf16 forward, K7 v2 backward) against the same model whose
    bucket attention keeps K6's forward values but takes autograd's gradient
    of the f32 forward at the same bf16 operands (plain PyTorch on the
    card), on the same sort orders: the whole gradient to 1e-2 relative L2
    (the level of phase 8's bf16 gradient against plain; the CPU test,
    `tests/test_torch_dynamic_bf16.py`, holds the same at 2 layers, 2 heads
    and each tensor besides). The worst tensor's max|d| over its scale
    floored at 2e-2 of the largest is logged, not gated: at full width the
    q projection weights' small gradients sum K7 v2's bf16-rounded g_so
    over the event (blocks.0.w_q: 2.0e-2 of the floored scale on an H100,
    the whole 1.5e-3)."""
    import hept_tpu_torch.ops.bucket_attn as ba
    from hept_tpu_torch.ops.bucket_attn_cuda import cols_fwd_plain

    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    loss_fn = trainer.make_loss_fn(cfg)
    perms = []
    _, kernel = loss_and_grads(torch, model, loss_fn, batch, record_perms=perms)
    kernels = ba.bucket_rbf_attention_cols

    def ad_backward(sq, sk, sv, block_size, mode):
        with torch.no_grad():
            den_k, so_k = kernels(sq, sk, sv, block_size, mode)
        den, so = cols_fwd_plain(sq.float(), sk.float(), sv.float(), block_size)
        return den + (den_k - den).detach(), so + (so_k - so).detach()

    ba.bucket_rbf_attention_cols = ad_backward
    try:
        _, ad = loss_and_grads(torch, model, loss_fn, batch, perms=perms)
    finally:
        ba.bucket_rbf_attention_cols = kernels
    floor = 2e-2 * max(scale(g) for g in ad.values())
    ratios = {k: max_err(kernel[k], ad[k]) / max(scale(ad[k]), floor) for k in ad}
    worst = max(ratios, key=ratios.get)
    diff2 = sum(float((kernel[k] - ad[k]).double().pow(2).sum()) for k in ad)
    norm2 = sum(float(ad[k].double().pow(2).sum()) for k in ad)
    whole = math.sqrt(diff2 / norm2)
    check("bf16 model gradient vs autograd of its forward, relative L2", whole, 1e-2)
    log(f"  worst tensor {worst}: max|d| / max(scale, 2e-2 largest) {ratios[worst]:.3e}")
    del model
    torch.cuda.empty_cache()
    return {"whole_rel_l2": whole, "worst": worst, "worst_ratio": ratios[worst]}


def phase_dynamic_bf16(torch, trainer, batch100_np, steps: int, seed: int, zero_counts,
                       read_counts) -> dict:
    """34. hept_fast's modes on dynamic keys: phase 28's share_heads model +
    sort_pack, unsort_pack, kernel_bf16 and kernel_center, attn_impl
    hybrid2: `steps` steps (K6 bf16 and K7 v2 on the tensor cores 4 each,
    K5 8 a step), busy ms, the first step against plain at phase 8's bf16
    gates; its gather_sort twin (bf16 60 B row gathers, K5 16 a step) with
    the same bits; then the model-level bf16-gradient check."""
    cfg = dynamic_config(**SHARE_HEADS, sort_pack=True, unsort_pack=True, kernel_bf16=True,
                         kernel_center=True)
    cfg.attn_impl = "hybrid2"
    launches = cols_launches(steps, 8, "cols_fwd_tc", "cols_bwd_tc")
    run = dynamic_steps(torch, trainer, cfg, batch100_np, steps, seed, zero_counts, read_counts,
                        "share_heads bf16", launches)
    twin = copy.deepcopy(cfg)
    twin.model_kwargs["gather_sort"] = True
    run["gather_sort"] = dynamic_steps(torch, trainer, twin, batch100_np, steps, seed,
                                       zero_counts, read_counts, "share_heads bf16 gather_sort",
                                       dict(launches, row_gather=16 * steps), profile=False,
                                       compare=False)
    same_run(torch, "share_heads bf16 gather_sort vs sort-carry", run, run["gather_sort"])
    run["gradient"] = bf16_gradient_check(torch, trainer, cfg, batch100_np, seed)
    return run


def phase_ckpt(torch, trainer, batch512_np, batch100_np, seed: int) -> dict:
    """35. use_ckpt: one Adam step with dropout of hept_acc (bs 512), the
    parity model and reformer (bs 100), each without and with use_ckpt from
    the same weights and generator: the same bits (loss, grad_norm, every
    parameter, the generator's state after the step), and the peak memory
    of each step (`torch.cuda.max_memory_allocated`)."""
    out = {}
    for profile, batch_np in (("hept_acc", batch512_np), ("hept", batch100_np),
                              ("reformer", batch100_np)):
        batch = trainer.batch_to_device(batch_np, DEVICE)
        runs = {}
        for ckpt in (False, True):
            cfg = dynamic_config(profile, use_ckpt=ckpt)
            model = trainer.build_model(cfg, batch_np["x"].shape[2],
                                        batch_np["coords"].shape[2],
                                        torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
            opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                         cfg.optimizer_kwargs["lr"])
            gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
            loss_fn = trainer.make_loss_fn(cfg)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = trainer.train_step(model, opt, loss_fn, batch, gen)
            metrics = (float(m["loss"]), float(m["grad_norm"]))
            torch.cuda.synchronize()
            runs[ckpt] = {"metrics": [metrics], "final_state": copy.deepcopy(model.state_dict()),
                          "gen": gen.get_state(), "ms": (time.perf_counter() - t0) * 1e3,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del model, opt
        same_run(torch, f"{profile} use_ckpt vs plain", runs[False], runs[True])
        if not torch.equal(runs[False]["gen"], runs[True]["gen"]):
            raise AssertionError(f"{profile}: use_ckpt left the generator elsewhere")
        out[profile] = {"peak_gib": runs[False]["peak_gib"], "ckpt_peak_gib": runs[True]["peak_gib"],
                        "ms": runs[False]["ms"], "ckpt_ms": runs[True]["ms"]}
        log(f"  {profile}: peak {runs[False]['peak_gib']:.2f} GiB plain, "
            f"{runs[True]['peak_gib']:.2f} GiB use_ckpt; step {runs[False]['ms']:.1f} / "
            f"{runs[True]['ms']:.1f} ms (first step of a fresh model)")
        del runs, batch
        torch.cuda.empty_cache()
    return out


def arm_config(arm: str, **model_kwargs):
    """The JAX demo's arm `arm` as the port's demo builds it
    (`scripts/train_60k_demo.py:arm_config`: lr 1e-2), with `model_kwargs`
    over its model kwargs."""
    from hept_tpu_torch.scripts.train_60k_demo import arm_config as demo_arm

    cfg = demo_arm(arm, 1e-2, 0, 1, tempfile.gettempdir(), DEVICE)
    cfg.model_kwargs.update(model_kwargs)
    return cfg


def fp8_model_config():
    """`scripts/validate_fp8_unsort.py`'s model: dynamic keys shared by the
    heads (share_heads), sort_pack, kernel_bf16, the fp8 unsort; bs 100, 3
    hashes, attn_impl hybrid, lr 1e-3."""
    from hept_tpu_torch.scripts.train_60k_demo import ARM_BASE
    from hept_tpu_torch.train.config import ExperimentConfig

    return ExperimentConfig(task="tracking", model_kwargs=dict(ARM_BASE, shared_sort=False,
                                                               unsort_pack="fp8"),
                            optimizer_kwargs={"lr": 1e-3}, num_epochs=1, batch_size=1,
                            batch_mode="flat", n_devices=1, attn_impl="hybrid", device=DEVICE)


def forward_out(torch, trainer, cfg, state, batch_np):
    """The model of `cfg` with parameters `state`: its output on the batch's
    event, dropout off, no gradient."""
    batch = trainer.batch_to_device(batch_np, DEVICE)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    model.load_state_dict(state)
    with torch.no_grad():
        out = model(batch["x"][0], batch["coords"][0], batch["valid"][0])
    del model
    return out


def fp8_transport_check(torch, seed: int) -> dict:
    """The fp8 unsort's transport on the card: the e4m3 / bf16 rounding of
    `core/buckets.py:_transport` and its K5 gather of the 50 B rows, bit
    for bit against the same on the CPU (the plain versions; NaN where the
    CPU has NaN, whatever its payload), on values past
    e4m3's range (464.1, 465, 480, 1e6, +-inf: NaN), at its limit (464:
    448), subnormal and in range; R 24 rows of (60000, 25)."""
    from hept_tpu_torch.core import buckets
    from hept_tpu_torch.ops import row_gather as rg

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((24, 60000, 25), generator=gen) * 100.0
    special = torch.tensor([463.9, 464.0, 464.1, 465.0, 480.0, 500.0, 448.0, 1e6, float("inf"),
                            -float("inf"), -464.5, -470.0, float("nan"), 1e-30, 2.0 ** -9,
                            2.0 ** -10, 3e-3, -0.0, 1e-20])
    x[0, :special.numel(), 0] = special
    x[1, :special.numel(), 24] = special  # the denominator column: bf16
    idx = torch.stack([torch.randperm(60000, generator=gen) for _ in range(24)])
    want = rg.row_gather_plain(buckets._transport(x, "fp8"), idx)
    xd, idxd = x.to(DEVICE), idx.to(DEVICE)
    rounded = buckets._transport(xd, "fp8")
    got = rg.row_gather_cuda(rounded, idxd)
    torch.cuda.synchronize()
    for label, a, b in (("rounding", rounded.cpu(), buckets._transport(x, "fp8")),
                        ("rounding + K5", got.cpu(), want)):
        # a NaN is a NaN: the card's conversions write another NaN payload
        nan_a, nan_b = a.isnan(), b.isnan()
        diff = (a.view(torch.int16) != b.view(torch.int16)) & ~nan_b
        if not torch.equal(nan_a, nan_b) or diff.any():
            raise AssertionError(f"fp8 transport {label}: card and CPU differ in "
                                 f"{int(diff.sum())} values and {int((nan_a != nan_b).sum())} "
                                 "NaN positions")
    nan = int(want.isnan().sum())
    head = buckets._transport(special[:, None].expand(-1, 2).contiguous(), "fp8")[:, 0]
    log(f"  fp8 transport: rounding and K5 gather bit-equal card vs CPU on 24 x 60000 x 25 "
        f"values ({nan} NaN out, at the CPU's NaN); e4m3 of {special.tolist()} -> "
        f"{head.float().tolist()}")
    return {"nan_out": nan}


def phase_static_family(torch, trainer, batch100_np, batch512_np, steps: int, seed: int,
                        zero_counts, read_counts) -> dict:
    """36. The static-plan family (module docstring): each run through
    `dynamic_steps` (steps, launches, busy ms, peak GiB, the first step
    against plain at the bf16 gates), the fp8 runs with their fp8
    transports' non-finite values counted, the fp8 transport on the card
    against the CPU, and
    the twins' forward bits."""
    from hept_tpu_torch.core import buckets

    hybrid = {**NO_K1_K2, "cols_fwd_tc": 4 * steps, "cols_fwd": 0, "cols_bwd": 4 * steps,
              "cols_bwd_tc": 0, "rows_fwd": 0, "rows_bwd": 0,
              **{k: v * steps for k, v in PAIR_LAUNCHES_STEP.items()}}
    slab = {**NO_K6_K7, "bucket_attn_fwd_tc": 4 * steps, "bucket_attn_bwd_tc": 4 * steps,
            "bucket_attn_fwd": 0, "bucket_attn_bwd": 0, "rows_fwd": 0, "rows_bwd": 0,
            **{k: v * steps for k, v in PAIR_LAUNCHES_STEP.items()}}
    # (label, config, batch, launches): K5 8 a step (the unsort, forward and
    # backward, a layer), 12 with the canonical / sigma entry and exit
    runs = [
        ("static", arm_config("static"), batch100_np, dict(hybrid, row_gather=8 * steps)),
        ("full", arm_config("full"), batch100_np, dict(hybrid, row_gather=12 * steps)),
        ("fullb4", arm_config("fullb4"), batch100_np, dict(hybrid, row_gather=12 * steps)),
        ("coordsb4", arm_config("coordsb4"), batch100_np, dict(hybrid, row_gather=12 * steps)),
        ("full + unsort_rows", arm_config("full", unsort_rows=True), batch100_np,
         dict(hybrid, row_gather=12 * steps)),
        ("static + fold_unsort", arm_config("static", fold_unsort=True), batch100_np,
         dict(hybrid, row_gather=8 * steps)),
        ("fp8 validate_fp8_unsort", fp8_model_config(), batch100_np,
         dict(hybrid, row_gather=8 * steps)),
        ("static + fp8", arm_config("static", unsort_pack="fp8"), batch100_np,
         dict(hybrid, row_gather=8 * steps)),
        ("nh2r8bs512cv2rg2", arm_config("nh2r8bs512cv2rg2"), batch512_np,
         dict(slab, row_gather=12 * steps)),
        ("nh2r8bs512cv2rg4", arm_config("nh2r8bs512cv2rg4"), batch512_np,
         dict(slab, row_gather=12 * steps)),
    ]
    out, cfgs = {}, {}
    transport = buckets._transport
    for label, cfg, batch_np, want in runs:
        bad = []

        def counting(x, pack, _transport=transport, _bad=bad):
            y = _transport(x, pack)
            if pack == "fp8":
                _bad.append((~torch.isfinite(y)).sum())
            return y

        if cfg.model_kwargs.get("unsort_pack") == "fp8":
            buckets._transport = counting
        try:
            out[label] = dynamic_steps(torch, trainer, cfg, batch_np, steps, seed, zero_counts,
                                       read_counts, label, want)
        finally:
            buckets._transport = transport
        if cfg.model_kwargs.get("unsort_pack") == "fp8":
            nonfinite = int(sum(int(b) for b in bad))
            out[label]["fp8_transports"], out[label]["fp8_nonfinite"] = len(bad), nonfinite
            log(f"  {label}: {len(bad)} fp8 transports (forward and backward), {nonfinite} "
                "non-finite values")
            if not bad or nonfinite:
                raise AssertionError(f"{label}: {nonfinite} non-finite fp8 values in "
                                     f"{len(bad)} transports")
        cfgs[label] = cfg
        top = sorted(out[label]["kernel_us"].items(), key=lambda kv: -kv[1])[:6]
        log(f"  {label}: the profiled step's top device kernels (ms): "
            + "; ".join(f"{k[:80]} {v / 1e3:.2f}" for k, v in top))
    out["fp8_transport"] = fp8_transport_check(torch, seed)
    # the twins' forward bits, on the static run's initial weights
    state = out["static"]["init_state"]
    ref = forward_out(torch, trainer, cfgs["static"], state, batch100_np)
    for label, cfg in (("static + fold_unsort", cfgs["static + fold_unsort"]),
                       ("static + unsort_rows", arm_config("static", unsort_rows=True))):
        got = forward_out(torch, trainer, cfg, state, batch100_np)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: forward differs from static's in "
                                 f"{int((got != ref).sum())} elements, max|d| {max_err(got, ref)}")
        log(f"  {label}: static's forward bits")
    f32 = dict(sort_pack=False, unsort_pack=False, kernel_bf16=False)
    plain32, canon32 = arm_config("static", **f32), arm_config("full", **f32)
    a = forward_out(torch, trainer, plain32, state, batch100_np)
    b = forward_out(torch, trainer, canon32, state, batch100_np)
    if not torch.equal(a, b):
        raise AssertionError(f"canon vs the plain plan, packing off: forward differs in "
                             f"{int((a != b).sum())} elements, max|d| {max_err(a, b)}")
    log("  canon (full, packing and bf16 kernels off): the plain plan's forward bits")
    batch = trainer.batch_to_device(batch100_np, DEVICE)
    grads = {}
    for label, cfg in (("plain", plain32), ("canon", canon32)):
        model = trainer.build_model(cfg, batch100_np["x"].shape[2],
                                    batch100_np["coords"].shape[2],
                                    torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        model.load_state_dict(state)
        grads[label] = loss_and_grads(torch, model, trainer.make_loss_fn(cfg), batch)
        del model
    (loss_a, ga), (loss_b, gb) = grads["plain"], grads["canon"]
    check("canon vs plain plan loss |d| / |loss|", abs(loss_a - loss_b) / abs(loss_a), 1e-4)
    floor = 1e-3 * max(scale(g) for g in ga.values())
    worst = max(max_err(gb[k], ga[k]) / max(scale(ga[k]), floor) for k in ga)
    check("canon vs plain plan: every parameter gradient / max(scale, 1e-3 largest)", worst,
          1e-3)
    out["canon_twin"] = {"loss_rel": abs(loss_a - loss_b) / abs(loss_a), "grad_ratio": worst}
    torch.cuda.empty_cache()
    return out


def hept_tpu_torch_root() -> str:
    import hept_tpu_torch

    return str(Path(hept_tpu_torch.__file__).parent.parent)


# 37. the modes the port once refused: post-sort dynamic keys under head /
# hash TP, use_ckpt under sharding, zero padding under the bucket SP
BF16_DYNAMIC = {"sort_pack": True, "unsort_pack": True, "kernel_bf16": True,
                "kernel_center": True}


def sharded_arms() -> dict:
    """Phase 37's TP models, (config, (hash shards, head shards)): (a) the
    parity YAML + qkv_post_sort, with and without shared_sort, 4 heads a
    rank; (b) phase 28's share_heads model at hept_fast's OR width 2 (the
    parity YAML's 3 does not split over 2 ranks), f32 and with phase 34's
    bf16 modes, one round a rank."""
    fast = dynamic_config(**SHARE_HEADS, n_hashes=2, **BF16_DYNAMIC)
    fast.attn_impl = "hybrid2"
    return {"post head tp": (dynamic_config(qkv_post_sort=True), (1, 2)),
            "shared_sort head tp": (dynamic_config(qkv_post_sort=True, shared_sort=True),
                                    (1, 2)),
            "share_heads hash tp": (dynamic_config(**SHARE_HEADS, n_hashes=2), (2, 1)),
            "share_heads bf16 hash tp": (fast, (2, 1))}


# (c): the arms repeated with use_ckpt, dropout on
CKPT_ARMS = ("post head tp", "share_heads hash tp")


def local_perms(perms: list, hash_rank: int, head_rank: int, lcfg) -> list:
    """This (hash, head) shard's slice of a single-process run's recorded
    sort orders: rounds [hash_rank * c, ...) and, per head, heads
    [head_rank * h, ...); share_heads' (c, n) orders have no head axis."""
    c, h = lcfg.n_hashes, lcfg.num_heads

    def cut(p):
        p = p[hash_rank * c:(hash_rank + 1) * c]
        return (p if p.dim() == 2 else p[:, head_rank * h:(head_rank + 1) * h]).to(DEVICE)

    return [tuple(cut(p) for p in pr) if isinstance(pr, tuple) else cut(pr) for pr in perms]


def sharded_reference(torch, trainer, batch100_np, batch_pad_np, seed: int) -> tuple:
    """37's single-process references and the ranks' inputs: each TP arm's
    loss and gradients (one step, dropout off) with its sort orders
    recorded; the zero-padded share_heads model's on the padded event; the
    distributed transport's fullest cell on that event's orders at cap
    factor 2.0."""
    from hept_tpu_torch.parallel.dsort import cell_fill

    inputs = {"tp": {}, "batch": batch100_np, "batch_pad": batch_pad_np, "seed": seed}
    ref = {"tp": {}}
    for arm, (cfg, sizes) in sharded_arms().items():
        batch = trainer.batch_to_device(batch100_np, DEVICE)
        model = trainer.build_model(cfg, batch100_np["x"].shape[2],
                                    batch100_np["coords"].shape[2],
                                    torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
        state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        perms = []
        loss, grads = loss_and_grads(torch, model, trainer.make_loss_fn(cfg), batch,
                                     record_perms=perms)
        inputs["tp"][arm] = {"cfg": cfg, "sizes": sizes, "state": state,
                             "perms": [tuple(p.cpu() for p in pr) if isinstance(pr, tuple)
                                       else pr.cpu() for pr in perms]}
        ref["tp"][arm] = {"loss": loss, "grads": grads}
        del model, batch
        torch.cuda.empty_cache()
    cfg = share_heads_config(padding_mode="zero")
    batch = trainer.batch_to_device(batch_pad_np, DEVICE)
    model = trainer.build_model(cfg, batch_pad_np["x"].shape[2], batch_pad_np["coords"].shape[2],
                                torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    perms = []
    loss, grads = loss_and_grads(torch, model, trainer.make_loss_fn(cfg), batch,
                                 record_perms=perms)
    inputs["bucket_zero"] = {"cfg": cfg, "state": state, "perms": [p.cpu() for p in perms]}
    ref["bucket_zero"] = {"loss": loss, "grads": grads}
    n = perms[0].shape[-1]
    cells = {}
    for p_ in (2, 4, 8):
        cap = max(1, -(-int(2.0 * n) // (p_ * p_)))
        full = max(int(cell_fill(s, p_).amax()) for s in perms)
        cells[p_] = {"fullest": full, "cap": cap, "overflow": full > cap}
    ref["cells"] = cells
    pads = int((~batch["valid"][0]).sum())
    log(f"  distributed transport on the zero-padded event ({pads} pad rows, {n} rows, the 4 "
        "layers' orders), fullest (source, destination) cell / cap at cap factor 2.0: "
        + ", ".join(f"{p_} ranks {c['fullest']} / {c['cap']}"
                    + (" OVERFLOW" if c["overflow"] else "") for p_, c in cells.items()))
    del model, batch
    torch.cuda.empty_cache()
    return inputs, ref


def rank_sharded(torch, trainer, inp: dict, world: int, counted, cpu) -> dict:
    """37 on one rank of `rank_worker`: (a) / (b) one Adam step of each TP
    arm, dropout off, on the single-process run's sort orders (this shard's
    slice); (c) the CKPT_ARMS' step with dropout, without and with use_ckpt,
    from the same weights and generator: the same bits, the generator's
    state after it, and each step's peak memory on this process; (d) the
    zero-padded share_heads model's bucket step over the ranks, each
    transport, on the single process's orders, without and with use_ckpt."""
    from hept_tpu_torch.parallel import tp
    from hept_tpu_torch.parallel.bp import make_bucket_model, make_bucket_train_step
    from hept_tpu_torch.parallel.dp import train_step
    from hept_tpu_torch.parallel.mesh import TP_AXES, make_mesh

    out = {}
    b = trainer.batch_to_device(inp["batch"], DEVICE)
    shape = (b["x"].shape[2], b["coords"].shape[2])
    for arm, a in inp["tp"].items():
        cfg, (hashes, heads) = a["cfg"], a["sizes"]
        mesh = make_mesh(world, TP_AXES, (world // (hashes * heads), hashes, heads),
                         device=DEVICE)
        model = tp.make_tp_model(cfg.model_config(*shape), mesh, None, DEVICE,
                                 state_dict=a["state"])
        perms = local_perms(a["perms"], mesh.rank("hashes"), mesh.rank("heads"), model.cfg)
        opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                     cfg.optimizer_kwargs["lr"])

        def apply(m_, b_, g_, perms=perms):
            return m_(b_["x"][0], b_["coords"][0], b_["valid"][0], g_, perms=perms)[None]

        out[f"tp {arm}"] = counted(
            f"tp {arm}", lambda: train_step(model, opt, trainer.make_loss_fn(cfg), apply, b,
                                            mesh.group("data"), None,
                                            sharded_norm=tp.sharded_global_norm(mesh)),
            lambda m: {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "grads": cpu(tp.gather_state_dict(
                           {k: p.grad for k, p in model.named_parameters()}, mesh))})
        del model, opt
        torch.cuda.empty_cache()
        if arm not in CKPT_ARMS:
            continue
        runs = {}
        for ckpt in (False, True):
            model = tp.make_tp_model(dataclasses.replace(cfg.model_config(*shape),
                                                         use_ckpt=ckpt),
                                     mesh, None, DEVICE, state_dict=a["state"])
            opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                         cfg.optimizer_kwargs["lr"])
            gen = tp.dropout_generator(inp["seed"], mesh.rank("data"), DEVICE)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg), b, gen,
                                   data_group=mesh.group("data"),
                                   sharded_norm=tp.sharded_global_norm(mesh))
            runs[ckpt] = {"metrics": (float(m["loss"]), float(m["grad_norm"])),
                          "state": copy.deepcopy(model.state_dict()), "gen": gen.get_state(),
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del model, opt
        same = runs[False]["metrics"] == runs[True]["metrics"] and all(
            torch.equal(v, runs[True]["state"][k]) for k, v in runs[False]["state"].items())
        out[f"ckpt {arm}"] = {"same_bits": same,
                              "same_gen": torch.equal(runs[False]["gen"], runs[True]["gen"]),
                              "metrics": runs[False]["metrics"],
                              "peak_gib": (runs[False]["peak_gib"], runs[True]["peak_gib"])}
        print(f"ckpt {arm}: same bits {same}, (loss, grad_norm) {runs[False]['metrics']} / "
              f"{runs[True]['metrics']}, peak GiB {runs[False]['peak_gib']:.3f} / "
              f"{runs[True]['peak_gib']:.3f}", flush=True)
        del runs
        torch.cuda.empty_cache()
    del b
    bz = inp["bucket_zero"]
    b = trainer.batch_to_device(inp["batch_pad"], DEVICE)
    mesh = make_mesh(world, ("data", "buckets"), (1, world), device=DEVICE)
    perms = [p_.to(DEVICE) for p_ in bz["perms"]]
    cfg = bz["cfg"]

    def apply(m_, b_, g_):
        return m_(b_["x"][0], b_["coords"][0], b_["valid"][0], g_, perms=perms)[None]

    for transport in BUCKET_TRANSPORTS:
        for ckpt in (False, True):
            tcfg = dataclasses.replace(cfg.model_config(*shape), use_ckpt=ckpt)
            model = make_bucket_model(tcfg, mesh, None, DEVICE, bz["state"], transport)
            opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                         cfg.optimizer_kwargs["lr"])
            step = make_bucket_train_step(model, opt, trainer.make_loss_fn(cfg), mesh,
                                          apply_fn=apply)
            label = f"bucket zero {transport}" + (" ckpt" if ckpt else "")
            out[label] = counted(
                label, lambda: step(b),
                lambda m: {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                           "grads": cpu({k: p.grad for k, p in model.named_parameters()})})
            del model, opt, step
            torch.cuda.empty_cache()
    return out


def check_sharded_ranks(torch, outs: list, ref: dict) -> None:
    """37's checks on the ranks' results. (a) / (b): each TP arm's loss 1e-4
    and each parameter gradient 1e-3 of its scale (floored at 1e-3 of the
    largest; phase 26's gates) against the single process, the bf16 arm's
    loss 1e-3 and whole gradient 1e-2 relative L2; K6 / K7 4 each a rank on
    their route (f32: K6 f32 and K7 v1; bf16: K6 bf16 and K7 v2), K5 8.
    (c): use_ckpt's bits and generator equal to the plain step's on every
    rank. (d): each transport's zero-padded bucket step, loss rtol 1e-5 and
    each gradient 1e-4 of its scale floored at 1e-3 of the largest (phase
    30's gates), K6 / K7 4 each, K5 8 replicated and 0 distributed; its
    use_ckpt run the same bits, with K6 re-run by the recompute (8)."""
    for arm, r in ref["tp"].items():
        bf16 = "bf16" in arm
        fwd, bwd = ("cols_fwd_tc", "cols_bwd_tc") if bf16 else ("cols_fwd", "cols_bwd")
        for rank, o in enumerate(outs):
            res = o[f"tp {arm}"]
            check_launches(f"tp {arm} rank {rank}", res["launches"],
                           {fwd: 4, bwd: 4, "row_gather": 8, **{k: 0 for k in NO_K6_K7
                                                                if k not in (fwd, bwd)}})
        t = outs[0][f"tp {arm}"]
        if any(o[f"tp {arm}"]["loss"] != t["loss"] for o in outs):
            raise AssertionError(f"tp {arm}: the ranks' losses differ")
        g = {k: v.to(DEVICE) for k, v in t["grads"].items()}
        if bf16:
            check(f"tp {arm} loss vs the single process |d| / |loss|",
                  abs(t["loss"] - r["loss"]) / abs(r["loss"]), 1e-3)
            check(f"tp {arm} gradient vs the single process, relative L2",
                  rel_l2(torch, g, r["grads"]), 1e-2)
            continue
        check(f"tp {arm} loss vs the single process |d| / |loss|",
              abs(t["loss"] - r["loss"]) / abs(r["loss"]), 1e-4)
        floor = 1e-3 * max(scale(gg) for gg in r["grads"].values())
        ratios = {k: max_err(g[k], r["grads"][k]) / max(scale(r["grads"][k]), floor)
                  for k in r["grads"]}
        worst = max(ratios, key=ratios.get)
        check(f"tp {arm}: all {len(ratios)} parameter gradients vs the single process, worst "
              f"{worst}", ratios[worst], 1e-3)
    for arm in CKPT_ARMS:
        for rank, o in enumerate(outs):
            c = o[f"ckpt {arm}"]
            if not (c["same_bits"] and c["same_gen"]):
                raise AssertionError(f"ckpt {arm} rank {rank}: use_ckpt changed the step "
                                     f"(bits {c['same_bits']}, generator {c['same_gen']})")
        log(f"  ckpt {arm}: use_ckpt the plain step's bits and generator on every rank (loss, "
            f"grad_norm {outs[0][f'ckpt {arm}']['metrics']}); peak GiB a rank plain / use_ckpt "
            + ", ".join(f"{o[f'ckpt {arm}']['peak_gib'][0]:.3f} / "
                        f"{o[f'ckpt {arm}']['peak_gib'][1]:.3f}" for o in outs))
    r = ref["bucket_zero"]
    floor = 1e-3 * max(scale(g) for g in r["grads"].values())
    for rank, o in enumerate(outs):
        for transport in BUCKET_TRANSPORTS:
            res, ck = o[f"bucket zero {transport}"], o[f"bucket zero {transport} ckpt"]
            k5 = 8 if transport == "replicated" else 0
            check_launches(f"bucket zero {transport} rank {rank}", res["launches"],
                           {"cols_fwd": 4, "cols_bwd": 4, "cols_fwd_tc": 0, "cols_bwd_tc": 0,
                            "row_gather": k5})
            check_launches(f"bucket zero {transport} ckpt rank {rank}", ck["launches"],
                           {"cols_fwd": 8, "cols_bwd": 4, "cols_fwd_tc": 0, "cols_bwd_tc": 0,
                            "row_gather": k5 * 3 // 2})
            check(f"bucket zero {transport} rank {rank} loss |d| / |loss|",
                  abs(res["loss"] - r["loss"]) / abs(r["loss"]), 1e-5)
            ratios = {k: max_err(res["grads"][k].to(DEVICE), g) / max(scale(g), floor)
                      for k, g in r["grads"].items()}
            worst = max(ratios, key=ratios.get)
            check(f"bucket zero {transport} rank {rank}: all {len(ratios)} parameter "
                  f"gradients, worst {worst}", ratios[worst], 1e-4)
            if (ck["loss"], ck["grad_norm"]) != (res["loss"], res["grad_norm"]) or not all(
                    torch.equal(ck["grads"][k], v) for k, v in res["grads"].items()):
                raise AssertionError(f"bucket zero {transport} rank {rank}: use_ckpt changed "
                                     "the step's bits")
            log(f"  bucket zero {transport} rank {rank}: use_ckpt the same bits (loss, "
                "grad_norm, every gradient)")


def phase_bucket_zero_nccl(torch, trainer, batch_pad_np, seed: int, zero_counts,
                           read_counts) -> dict:
    """37 (d) at world 1 over NCCL, as phase 29: the zero-padded share_heads
    model's single-device step (dropout on) and its bucket step on a
    one-rank ("data", "buckets") mesh, each transport, without and with
    use_ckpt, from the same weights and dropout seed: the single device's
    bits (loss, grad_norm, every parameter). Launches: K6 / K7 4 each, K5 8
    replicated and 0 distributed; under use_ckpt K6 8 and K5 12 / 0."""
    import datetime

    import torch.distributed as dist

    from hept_tpu_torch.parallel.bp import make_bucket_model, make_bucket_train_step
    from hept_tpu_torch.parallel.mesh import make_mesh

    cfg = share_heads_config(padding_mode="zero")
    ref = dynamic_steps(torch, trainer, cfg, batch_pad_np, 1, seed, zero_counts, read_counts,
                        "zero-padded share_heads (single device)", cols_launches(1),
                        profile=False, compare=False)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh(1, ("data", "buckets"), (1, 1), device=DEVICE)
        batch = trainer.batch_to_device(batch_pad_np, DEVICE)
        base = cfg.model_config(batch_pad_np["x"].shape[2], batch_pad_np["coords"].shape[2])
        for transport in BUCKET_TRANSPORTS:
            for ckpt in (False, True):
                model = make_bucket_model(dataclasses.replace(base, use_ckpt=ckpt), mesh, None,
                                          DEVICE, ref["init_state"], transport)
                opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                             cfg.optimizer_kwargs["lr"])
                step = make_bucket_train_step(model, opt, trainer.make_loss_fn(cfg), mesh,
                                              seed=seed + 1)
                torch.cuda.synchronize()
                zero_counts()
                m = step(batch)
                metrics = [(float(m["loss"]), float(m["grad_norm"]))]
                torch.cuda.synchronize()
                launches = read_counts()
                label = f"bucket zero nccl {transport}" + (" ckpt" if ckpt else "")
                k5 = 8 if transport == "replicated" else 0
                check_launches(label, launches, dict(
                    cols_launches(1, k5 * 3 // 2 if ckpt else k5),
                    cols_fwd=8 if ckpt else 4))
                same_run(torch, f"{label} vs the single device", ref,
                         {"metrics": metrics, "final_state": model.state_dict()})
                res[label] = launches
                del model, opt, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


def phase_sharded_modes(torch, trainer, batch100_np, seed: int, zero_counts,
                        read_counts) -> dict:
    """37. The modes the port once refused, on one card: (a) head TP 2 of
    the per-head post-sort models, (b) hash TP 2 of the share_heads models,
    (c) use_ckpt under both, (d) zero padding under the bucket SP (an event
    of `points - 50` points in the bs-100 event's rows) over two gloo ranks
    sharing the card (`spawn_ranks`) and at world 1 over NCCL. Correctness
    only: one card measures no scaling."""
    n = batch100_np["x"].shape[1]
    _, batch_pad = make_batch(n - 50, seed, 100)
    if batch_pad["x"].shape[1] != n or int((~batch_pad["valid"]).sum()) != 50:
        raise AssertionError("the padded event does not hold 50 pad rows in the bs-100 rows")
    nccl = phase_bucket_zero_nccl(torch, trainer, batch_pad, seed, zero_counts, read_counts)
    inputs, ref = sharded_reference(torch, trainer, batch100_np, batch_pad, seed)
    t0 = time.perf_counter()
    outs = spawn_ranks(2, {"phase37": inputs})
    log(f"  two ranks: 2 processes on the card (gloo), {time.perf_counter() - t0:.1f} s wall "
        "including their start")
    check_sharded_ranks(torch, outs, ref)
    keys = [k for k in outs[0] if "launches" in outs[0][k]]
    return {"launches": {k: [o[k]["launches"] for o in outs] for k in keys},
            "ms": {k: [o[k]["ms"] for o in outs] for k in keys},
            "ckpt": {arm: [o[f"ckpt {arm}"]["peak_gib"] for o in outs] for arm in CKPT_ARMS},
            "nccl": nccl, "cells": ref["cells"]}


def phase_xla_impl(torch, trainer, batch100_np, steps: int, seed: int, zero_counts,
                   read_counts) -> dict:
    """38. attn_impl "xla" at full width on the bs-100 event, each run
    through `dynamic_steps` (launches, busy ms, peak GiB, the first step
    against plain): (a) the parity YAML with "xla", f32 (K6 f32 / K7 v1 4
    each a step), at the f32 gates, and its "hybrid" twin with the same bits;
    (b) hept_fast with "xla" (K6 exact-bias bf16 on the tensor cores, K7 v1
    on bf16), at the bf16 gates, and its "hybrid" twin with the same bits;
    (c) the model of a bare TransformerConfig(in_dim, coords_dim) (zero
    padding, "xla", bs 100, 3 hashes) and that of ExperimentConfig()
    (replicate padding, "pallas"), trained by ExperimentConfig()'s loss and
    optimizer: one step each, at the f32 gates."""
    from hept_tpu_torch.models.transformer import TransformerConfig
    from hept_tpu_torch.train.config import ExperimentConfig

    out = {}
    # K6 on the f32 or the tensor-core route, K7 v1 (cols_bwd) either way
    for label, profile, fwd in (("parity xla", "hept", "cols_fwd"),
                                ("hept_fast xla", "hept_fast", "cols_fwd_tc")):
        want = cols_launches(steps, fwd=fwd)
        out[label] = dynamic_steps(torch, trainer,
                                   dynamic_config(profile, {"attn_impl": "xla"}), batch100_np,
                                   steps, seed, zero_counts, read_counts, label, want)
        twin = label.replace("xla", "hybrid")
        out[twin] = dynamic_steps(torch, trainer,
                                  dynamic_config(profile, {"attn_impl": "hybrid"}), batch100_np,
                                  steps, seed, zero_counts, read_counts, twin, want,
                                  profile=False, compare=False)
        same_run(torch, f"{label} vs {twin}", out[label], out[twin])
    in_dim, coords_dim = batch100_np["x"].shape[2], batch100_np["coords"].shape[2]
    bare = ExperimentConfig(padding_mode="zero", attn_impl="xla")
    if bare.model_config(in_dim, coords_dim) != TransformerConfig(in_dim, coords_dim):
        raise AssertionError("the zero / xla experiment does not build the bare "
                             "TransformerConfig's model")
    for label, cfg in (("TransformerConfig() defaults", bare),
                       ("ExperimentConfig() defaults", ExperimentConfig())):
        mc = cfg.model_config(in_dim, coords_dim)
        log(f"  {label}: padding {mc.padding_mode}, attn_impl {mc.attn_impl}, bs "
            f"{mc.block_size}, {mc.n_hashes} hashes, {mc.n_layers} layers, {mc.num_heads} "
            f"heads, h_dim {mc.h_dim}")
        out[label] = dynamic_steps(torch, trainer, cfg, batch100_np, 1, seed, zero_counts,
                                   read_counts, label, cols_launches(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--yardsticks-only", action="store_true",
                    help="build the kernels, print K2's, K3's, K4's, K5's, K6's, K7's, K10's and "
                         "K12's times at the paths' shapes as one JSON line, and stop (no result "
                         "line)")
    ap.add_argument("--package-root", default=None,
                    help="import hept_tpu_torch from this directory instead (a parent tree "
                         "for an A/B of the yardsticks)")
    ap.add_argument("--rank-worker", default=None, metavar="DIR",
                    help="(internal) run one rank of the two-rank phases on DIR's inputs")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    if args.steps < 3 or args.profile_steps < 2:
        ap.error("--steps must be at least 3 and --profile-steps at least 2")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.package_root is not None:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
    try:
        import hept_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the hept_tpu_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    if args.yardsticks_only:
        return yardsticks_only(torch, args)
    if args.rank_worker is not None:
        return rank_worker(torch, args)
    from hept_tpu_torch.data.datasets import SplitDataset
    from hept_tpu_torch.ops import bucket_attn_cuda, cuda_lib, pair_ops, row_gather, sort
    from hept_tpu_torch.ops.dispatch import plain_reference
    from hept_tpu_torch.train import trainer
    from hept_tpu_torch.train.config import profile_config

    t_start = time.perf_counter()
    # 1. build
    secs = cuda_lib.build(force=True)
    smi = nvidia_smi_line()
    log(f"phase build: {secs:.1f} s for {len(cuda_lib.SOURCES)} sources in parallel; "
        f"card: {smi}")
    for nm in cuda_lib.SOURCES:
        for line in cuda_lib.build_log[nm].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {nm}: {line.strip()}")
    from hept_tpu_torch import native
    from hept_tpu_torch.data.synthetic import pairs_backend

    if native._LIB.exists():
        native._LIB.unlink()  # built from this checkout's source, now
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native host library (hept_tpu_torch/native) did not build")
    log(f"phase build: native host library (g++) {time.perf_counter() - t0:.1f} s; synthetic "
        f"pairs backend: {pairs_backend()}")

    cfg = profile_config("hept_acc", device=DEVICE, num_epochs=1)
    block_size = cfg.model_kwargs["block_size"]
    t0 = time.perf_counter()
    event, batch_np = make_batch(args.points, args.seed, block_size)
    batch = trainer.batch_to_device(batch_np, DEVICE)
    log(f"phase data: one synthetic event, {args.points} points -> n={batch_np['x'].shape[1]}, "
        f"E={batch_np['pairs'].shape[-1]} windowed pairs ({time.perf_counter() - t0:.1f} s)")

    # 2. kernels vs plain versions
    rows = phase_kernels(torch, batch_np, args.seed)
    rows.update(phase_row_gather(torch, batch_np["x"].shape[1], args.seed))
    torch.cuda.empty_cache()
    rows.update(phase_cols_kernels(torch, args.seed))
    torch.cuda.empty_cache()
    rows.update(phase_cols_kernels(torch, args.seed, d=28))
    log("phase kernels: K1-K9 match their plain versions (K6 / K7 at d = 30 and 28)")

    # 3. the main path
    gen_init = torch.Generator(device=DEVICE).manual_seed(args.seed)
    model = trainer.build_model(cfg, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                gen_init, DEVICE)
    init_state = copy.deepcopy(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), cfg.optimizer_name,
                                 cfg.optimizer_kwargs["lr"])
    loss_fn = trainer.make_loss_fn(cfg)
    gen_drop = torch.Generator(device=DEVICE).manual_seed(args.seed + 1)
    torch.cuda.synchronize()
    counters = (bucket_attn_cuda.LAUNCHES, pair_ops.LAUNCHES, pair_ops.CSR_BUILDS,
                row_gather.LAUNCHES, sort.LAUNCHES)

    def zero_counts():
        for counts in counters:
            for k in counts:
                counts[k] = 0

    def read_counts() -> dict:
        return {k: v for counts in counters for k, v in counts.items()}

    zero_counts()
    step_ms, losses = [], []
    for s in range(args.steps):
        t0 = time.perf_counter()
        m = trainer.train_step(model, opt, loss_fn, batch, gen_drop)
        loss = float(m["loss"])  # synchronises
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"  step {s}: loss={loss:.6f} grad_norm={float(m['grad_norm']):.4f} "
            f"{step_ms[-1]:.1f} ms")
    launches = read_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # per step and layer: one K1, one K2 (tensor cores; the scalar route none),
    # and the unsort's K5 forward and backward
    want = {"bucket_attn_fwd_tc": 4 * args.steps, "bucket_attn_bwd_tc": 4 * args.steps,
            "bucket_attn_fwd": 0, "bucket_attn_bwd": 0, **NO_K6_K7, "rows_fwd": 0, "rows_bwd": 0,
            "row_gather": 8 * args.steps,
            **{k: v * args.steps for k, v in PAIR_LAUNCHES_STEP.items()}}
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{k} launched {launches[k]}x in {args.steps} steps, want {v}")
    steady = statistics.median(step_ms[1:])
    log(f"phase main: {args.steps} hept_acc steps (4 layers, 8 heads, h_dim 24, bs 512, "
        f"8 static rounds, dropout on), losses {losses}; step ms {step_ms}; "
        f"median after the first {steady:.1f} ms; launches {launches}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key, name in (("K1", "bucket_attn_fwd_tc"), ("K2", "bucket_attn_bwd_tc"),
                      ("K4", "pair_segment_sum"), ("K5", "row_gather")):
        rows[key]["launches"] = launches[name]
    rows["K3"]["launches"] = launches["pair_gather"] - launches["pair_gather_d1"]
    rows["K3d1"]["launches"] = launches["pair_gather_d1"]
    rows["K4"]["csr_builds"] = launches["anchor_csr"]
    rows["K5"]["launches_in"] = f"phase 3, {args.steps} hept_acc steps"
    trained_state = copy.deepcopy(model.state_dict())

    # 4. the first step with kernels vs with plain versions, dropout off
    model.load_state_dict(init_state)
    loss_k, grads_k = loss_and_grads(torch, model, loss_fn, batch)
    with plain_reference():
        loss_p, grads_p = loss_and_grads(torch, model, loss_fn, batch)
    log(f"phase compare (hept_acc, bf16 kernels): loss kernels {loss_k:.6f} plain {loss_p:.6f}")
    check("loss |d|", abs(loss_k - loss_p), 1e-3 * abs(loss_p))
    # pt is rounded to bf16 in K1 and the bf16 gradients in K2; the two
    # paths' f32 sums differ in order, so some roundings flip. At init the
    # q/k projection weights' gradients are tiny and ill-conditioned under
    # such flips (a perturbation at f32 rounding level of K1's output moves
    # them by a sizeable share of their own scale), so in bf16 the gradient
    # is held as a whole: relative L2 error over all parameters.
    diff2 = sum(float((grads_k[k] - grads_p[k]).double().pow(2).sum()) for k in grads_p)
    norm2 = sum(float(grads_p[k].double().pow(2).sum()) for k in grads_p)
    check("gradient, |g_kernels - g_plain| / |g_plain| over all parameters",
          math.sqrt(diff2 / norm2), 1e-2)
    ratios = {k: max_err(grads_k[k], grads_p[k]) / (scale(grads_p[k]) + 1e-6) for k in grads_p}
    worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
    log("  per tensor, max|d| / (max|plain| + 1e-6), largest: "
        + ", ".join(f"{k} {ratios[k]:.3e}" for k in worst))
    # the same step with the bf16 modes off (f32 transport, f32 K1/K2):
    # no bf16 rounding to flip, so every parameter gradient is held on its own
    cfg32 = profile_config("hept_acc", device=DEVICE, num_epochs=1)
    cfg32.model_kwargs.update(sort_pack=False, unsort_pack=False, kernel_bf16=False)
    model32 = trainer.build_model(cfg32, batch_np["x"].shape[2], batch_np["coords"].shape[2],
                                  gen_init, DEVICE)
    model32.load_state_dict(init_state)
    zero_counts()
    loss_k, grads_k = loss_and_grads(torch, model32, loss_fn, batch)
    launches32 = read_counts()
    want = {"bucket_attn_fwd": 4, "bucket_attn_bwd": 4, "bucket_attn_fwd_tc": 0,
            "bucket_attn_bwd_tc": 0}
    for k, v in want.items():
        if launches32[k] != v:
            raise AssertionError(f"the f32 step launched {k} {launches32[k]}x, want {v}")
    rows["K1"]["scalar_f32_launches"] = launches32["bucket_attn_fwd"]
    rows["K2"]["scalar_f32_launches"] = launches32["bucket_attn_bwd"]
    rows["K5f32"]["launches"] = launches32["row_gather"]
    rows["K5f32"]["launches_in"] = "phase 4, one hept_acc step with its bf16 modes off"
    with plain_reference():
        loss_p, grads_p = loss_and_grads(torch, model32, loss_fn, batch)
    log(f"phase compare (f32 kernels): loss kernels {loss_k:.6f} plain {loss_p:.6f}")
    check("loss |d|", abs(loss_k - loss_p), 1e-5 * abs(loss_p))
    # each tensor against its own scale, floored at 1e-3 of the largest
    # gradient (the output bias's gradient is zero up to rounding: the loss
    # depends on embedding differences only); 1e-2 because a point whose ReLU
    # pre-activation or RBF logit sits at its kink within f32 rounding can
    # switch sides between the paths and move a weight's gradient by ~1e-3
    floor = 1e-3 * max(scale(g) for g in grads_p.values())
    ratios = {k: max_err(grads_k[k], grads_p[k]) / max(scale(grads_p[k]), floor)
              for k in grads_p}
    worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
    log("  per tensor, max|d| / max(max|plain|, 1e-3 max over tensors), largest: "
        + ", ".join(f"{k} {ratios[k]:.3e}" for k in worst))
    check(f"all {len(ratios)} parameter gradients, worst {worst[0]}", ratios[worst[0]], 1e-2)
    del model32, grads_k, grads_p, opt
    torch.cuda.empty_cache()

    # 5. the eval path, with the phase-3 weights
    model.load_state_dict(trained_state)
    phase_eval(torch, trainer, model, cfg, event, batch, zero_counts, read_counts)

    # 6. the trainer: one epoch, checkpoint, restore, re-eval
    del model, init_state, trained_state
    torch.cuda.empty_cache()
    phase_trainer(torch, trainer, args.points, args.seed)

    # 7./8. the bs-100 profiles on one event packed for block_size 100
    t0 = time.perf_counter()
    event100, batch100 = make_batch(args.points, args.seed, 100)
    ds100 = SplitDataset(train=[], valid=[], test=[event100], in_dim=event100.x.shape[1],
                         coords_dim=event100.coords.shape[1])
    log(f"phase data: the event packed for block_size 100 -> n={batch100['x'].shape[1]} "
        f"({time.perf_counter() - t0:.1f} s)")
    # 7. parity: K6 and K7 v1 on FP32 FMAs; 8. hept_fast: K6 and K7 v2 on the
    # tensor cores
    parity = phase_profile(torch, trainer, "hept", batch100, ds100, args.profile_steps,
                           args.seed, zero_counts, read_counts, fwd="cols_fwd", bwd="cols_bwd")
    rows["K6"]["launches"] = parity["launches"]["cols_fwd"]
    rows["K6"]["launches_in"] = f"phase 7, {args.profile_steps} parity steps (f32)"
    rows["K5p"]["launches"] = parity["launches"]["row_gather"]
    rows["K5p"]["launches_in"] = f"phase 7, {args.profile_steps} parity steps"
    rows["K7"]["launches"] = parity["launches"]["cols_bwd"]
    rows["K7"]["launches_in"] = f"phase 7, {args.profile_steps} parity steps (v1)"
    fast = phase_profile(torch, trainer, "hept_fast", batch100, ds100, args.profile_steps,
                         args.seed, zero_counts, read_counts, fwd="cols_fwd_tc",
                         bwd="cols_bwd_tc")
    rows["K6"]["bf16_tc_launches"] = fast["launches"]["cols_fwd_tc"]
    rows["K6"]["bf16_tc_launches_in"] = f"phase 8, {args.profile_steps} hept_fast steps"
    rows["K7"]["v2_tc_launches"] = fast["launches"]["cols_bwd_tc"]
    rows["K7"]["v2_tc_launches_in"] = f"phase 8, {args.profile_steps} hept_fast steps"

    # 9. the row-major core (K10), 10. the slab modes (K8/K9), 11. the sort (K12)
    core_rows, core_launches = phase_core(torch, trainer, batch100, args.seed, zero_counts,
                                          read_counts)
    rows.update(core_rows)
    for key in ("K5q", "K5v"):
        rows[key]["launches"] = core_launches["row_gather"]
        rows[key]["launches_in"] = ("phase 9, one hept_attention_core forward + backward "
                                    "(120, 96 and 100 B rows together)")
    slab = phase_slab(torch, trainer, batch100, args.seed, zero_counts, read_counts)
    rows["K8"]["launches"] = slab["slab"]["cols_fwd_tc"]
    rows["K9"]["launches"] = slab["slab"]["cols_bwd"] + slab["hybrid_slab"]["cols_bwd"]
    rows["K12"] = phase_sort(torch, args.seed, zero_counts, read_counts)

    # 12. hept_max: K1 / K2 on the tensor cores at OR width 3 over 12 static
    # rounds, on the phase-3 event
    ds512 = SplitDataset(train=[], valid=[], test=[event], in_dim=event.x.shape[1],
                         coords_dim=event.coords.shape[1])
    hmax = phase_profile(torch, trainer, "hept_max", batch_np, ds512, args.profile_steps,
                         args.seed, zero_counts, read_counts, fwd="bucket_attn_fwd_tc",
                         bwd="bucket_attn_bwd_tc")
    for key, name in (("K1", "bucket_attn_fwd_tc"), ("K2", "bucket_attn_bwd_tc")):
        rows[key]["hept_max_launches"] = hmax["launches"][name]
        rows[key]["hept_max_launches_in"] = f"phase 12, {args.profile_steps} hept_max steps"
    del ds512
    torch.cuda.empty_cache()

    # 13./14. the pileup profiles on one synthetic 60k pileup event (bs 100,
    # d = 24 + 4): 13. parity (K6 / K7 v1 on FP32 FMAs), 14. hept_fast (K6 /
    # K7 v2 on the tensor cores); 15. the pileup trainer
    t0 = time.perf_counter()
    pev, pbatch = make_pileup_batch(args.points, args.seed, 100)
    pds = SplitDataset(train=[], valid=[], test=[pev], in_dim=pev.x.shape[1],
                       coords_dim=pev.coords.shape[1])
    log(f"phase data: one synthetic pileup event, {args.points} points -> "
        f"n={pbatch['x'].shape[1]}, {int(pev.is_neu.sum())} neutral points scored "
        f"({time.perf_counter() - t0:.1f} s)")
    pparity = phase_profile(torch, trainer, "hept", pbatch, pds, args.profile_steps, args.seed,
                            zero_counts, read_counts, fwd="cols_fwd", bwd="cols_bwd",
                            task="pileup")
    pfast = phase_profile(torch, trainer, "hept_fast", pbatch, pds, args.profile_steps,
                          args.seed, zero_counts, read_counts, fwd="cols_fwd_tc",
                          bwd="cols_bwd_tc", task="pileup")
    for key, fwd, pre in (("K6d28", True, "bf16_tc_"), ("K7d28", False, "v2_tc_")):
        rows[key]["launches"] = pparity["launches"]["cols_fwd" if fwd else "cols_bwd"]
        rows[key]["launches_in"] = (f"phase 13, {args.profile_steps} pileup parity steps "
                                    + ("(f32)" if fwd else "(v1)"))
        rows[key][pre + "launches"] = pfast["launches"]["cols_fwd_tc" if fwd else "cols_bwd_tc"]
        rows[key][pre + "launches_in"] = f"phase 14, {args.profile_steps} pileup hept_fast steps"
    torch.cuda.empty_cache()
    phase_trainer(torch, trainer, args.points, args.seed, task="pileup", profile="hept_fast")

    # 16./17. the seven baseline attentions on the bs-100 tracking event and
    # the pileup event
    from hept_tpu_torch.models.transformer import BASELINES

    base = {}
    for task, bnp, bds, steps in (("tracking", batch100, ds100, 2), ("pileup", pbatch, pds, 1)):
        for attn in BASELINES:
            base[task, attn] = phase_baseline(torch, trainer, attn, task, bnp, bds, steps,
                                              args.seed, zero_counts, read_counts)
    # 18./19. the four GNN baselines on the same two events
    from hept_tpu_torch.models.gnns import CONVS
    from hept_tpu_torch.train.config import gnn_config_path, load_config

    gnn = {}
    for task, bnp, bds, steps in (("tracking", batch100, ds100, 2), ("pileup", pbatch, pds, 1)):
        for conv in CONVS:
            gcfg = load_config(gnn_config_path(conv, task), device=DEVICE, num_epochs=1)
            gnn[task, conv] = phase_baseline(torch, trainer, f"gnn_{conv}", task, bnp, bds, steps,
                                             args.seed, zero_counts, read_counts, cfg=gcfg)
    del pds, pbatch
    log(f"phase baselines ({smi}): task attn | step ms (median after the first; pileup: its one "
        "step) | profiled step ms | device busy ms | peak GiB | eval ms | K3 ms | K4 ms a step")
    for (task, attn), r in base.items():
        log(f"  {task} {attn} | {r['steady_ms']:.1f} | {r['profiled_step_ms']:.1f} | "
            f"{r['busy_ms']:.1f} | {r['peak_gib']:.2f} | {r['eval_ms']:.1f} | {r['k3_ms']:.3f} | "
            f"{r['k4_ms']:.3f}")
    log(f"phase gnns ({smi}): task conv | step ms (median after the first; pileup: its one "
        "step) | profiled step ms | device busy ms | idle share (1 - busy / profiled step) | "
        "peak GiB | eval ms | torch.topk ms (share of busy) | K3 ms | K4 ms a step")
    for (task, conv), r in gnn.items():
        log(f"  {task} {conv} | {r['steady_ms']:.1f} | {r['profiled_step_ms']:.1f} | "
            f"{r['busy_ms']:.1f} | {1 - r['busy_ms'] / r['profiled_step_ms']:.3f} | "
            f"{r['peak_gib']:.2f} | {r['eval_ms']:.1f} | {r['topk_ms']:.2f} "
            f"({r['topk_ms'] / r['busy_ms']:.2f}) | {r['k3_ms']:.3f} | {r['k4_ms']:.3f}")
    # 20. each baseline and GNN on the CPU against the card; 21. the GNN
    # trainer (the -c path of tracking_gnn_gravnet.yaml on its own dataset's
    # events); 22. the trainer's loss and optimizer options on hept_acc
    phase_cpu_vs_card(torch, trainer, args.seed)
    phase_trainer(torch, trainer, 6000, args.seed, config_path=gnn_config_path("gravnet"))
    options = phase_train_options(torch, trainer, event, batch_np, args.seed, zero_counts,
                                  read_counts)
    # the K3 / K4 launches of each tracking run of phases 16, 18 and 22, each
    # kernel's by width: K3 and K4 at d = 12, K3d1 and K4's d1_launches at d = 1
    runs = {"baseline": ({attn: base["tracking", attn]["launches"] for attn in BASELINES},
                         "phase 16, 2 steps of each tracking baseline"),
            "gnn": ({conv: gnn["tracking", conv]["launches"] for conv in CONVS},
                    "phase 18, 2 steps of each tracking GNN"),
            "option": ({k: v for k, v in options.items() if k != "adamw_cosine_lrs"},
                       "phase 22, one hept_acc step of each loss option")}
    for key, count in (("K3", lambda c: c["pair_gather"] - c["pair_gather_d1"]),
                       ("K3d1", lambda c: c["pair_gather_d1"]),
                       ("K4", lambda c: c["pair_segment_sum"] - c["pair_segment_sum_d1"])):
        for kind, (per_run, where) in runs.items():
            rows[key][f"{kind}_launches"] = {name: count(c) for name, c in per_run.items()}
            rows[key][f"{kind}_launches_in"] = where
    rows["K4"]["d1_launches"] = {f"{kind} {name}": c["pair_segment_sum_d1"]
                                 for kind, (per_run, _) in runs.items()
                                 for name, c in per_run.items()}
    rows["K4"]["launches_note"] = ("launches: all widths (phase 3); baseline_launches, "
                                   "gnn_launches and option_launches: at d = 12; d1_launches: "
                                   "at d = 1")
    # 23. flat batching of two events; 24. DP at world 1 over NCCL; 25.-27.
    # DP, head-TP and the head-sharded core over two ranks sharing the card
    t0 = time.perf_counter()
    _, batch2 = make_batch2(args.points, (args.seed, args.seed + 1), block_size)
    log(f"phase data: two synthetic events (seeds {args.seed}, {args.seed + 1}) packed as one "
        f"batch ({time.perf_counter() - t0:.1f} s)")
    flat = phase_flat(torch, trainer, batch2, args.profile_steps, args.seed, zero_counts,
                      read_counts)
    dp1 = phase_dp_nccl(torch, trainer, batch_np, args.seed)
    # 28. the dynamic-key share_heads model; 29. its bucket train step at
    # world 1 over NCCL, both transports; 30. (in the two-rank spawn) the
    # bucket-sharded core and step over two ranks sharing the card
    share = phase_share_heads(torch, trainer, batch100, args.profile_steps, args.seed,
                              zero_counts, read_counts)
    bucket1 = phase_bucket_nccl(torch, trainer, batch100, args.seed, share, zero_counts,
                                read_counts)
    two = phase_two_ranks(torch, trainer, batch2, batch100, args.seed, share)
    for key, name in (("K1", "bucket_attn_fwd_tc"), ("K2", "bucket_attn_bwd_tc")):
        rows[key]["flat_launches"] = flat["flat"]["launches"][name]
        rows[key]["flat_launches_in"] = (f"phase 23, {args.profile_steps} flat hept_acc steps "
                                         "of 2 events")
        rows[key]["dp_launches"] = [ln.get(name, 0) for ln in two["dp"]]
        rows[key]["dp_launches_in"] = "phase 25, one DP step, by rank (an event a rank)"
    for key, name in (("K6", "cols_fwd"), ("K7", "cols_bwd")):
        rows[key]["tp_launches"] = [ln.get(name, 0) for ln in two["tp"]]
        rows[key]["tp_launches_in"] = "phase 26, one parity step with shard_heads 2, by rank"
    for key, name in (("K10f", "rows_fwd"), ("K10b", "rows_bwd")):
        rows[key]["sp_launches"] = [ln.get(name, 0) for ln in two["sp"]]
        rows[key]["sp_launches_in"] = ("phase 27, head_sharded_attention forward + backward, "
                                       "by rank")
    for key, name in (("K6", "cols_fwd"), ("K7", "cols_bwd"), ("K5p", "row_gather")):
        rows[key]["share_heads_launches"] = share["launches"][name]
        rows[key]["share_heads_launches_in"] = (f"phase 28, {args.profile_steps} share_heads "
                                                "steps")
        rows[key]["bucket_nccl_launches"] = {t: r["launches"][name] for t, r in bucket1.items()}
        rows[key]["bucket_nccl_launches_in"] = (f"phase 29, {args.profile_steps} bucket steps "
                                                "at world 1, by transport")
        rows[key]["bucket_rank_launches"] = {t: [ln.get(name, 0)
                                                 for ln in two[f"bucket_step_{t}"]]
                                             for t in BUCKET_TRANSPORTS}
        rows[key]["bucket_rank_launches_in"] = ("phase 30, one bucket step with 2 bucket "
                                                "shards, by transport and rank")
    log(f"phase parallel ({smi}): flat B=2 step {flat['flat']['steady_ms']:.1f} ms (busy "
        f"{flat['flat']['busy_ms']:.2f}) vs loop {flat['loop']['steady_ms']:.1f} ms (busy "
        f"{flat['loop']['busy_ms']:.2f}) vs one event {flat['one event']['steady_ms']:.1f} ms "
        f"(busy {flat['one event']['busy_ms']:.2f}); NCCL world-1 DP step "
        f"{dp1['dp']['steady_ms']:.1f} ms vs plain {dp1['plain']['steady_ms']:.1f} ms; "
        f"share_heads step {share['steady_ms']:.1f} ms (busy {share['busy_ms']:.2f}); NCCL "
        f"world-1 bucket step " + ", ".join(f"{t} {r['steady_ms']:.1f} ms"
                                            for t, r in bucket1.items())
        + f"; two ranks on one card (correctness, not scaling): ms by rank (first, warm) "
          f"{two['ms']}")

    # 31. a reference-layout archive through get_dataset, and the example
    phase_reference_data(torch, trainer, args.seed, zero_counts, read_counts)

    # 32.-35. the dynamic-key modes: zero padding, per-head keys after the
    # sort, shared_sort, gather_sort, fold_unsort, bf16 on dynamic keys,
    # use_ckpt
    log("phase 32 zero padding:")
    zero = phase_zero_padding(torch, trainer, batch100, batch_np, args.profile_steps, args.seed,
                              zero_counts, read_counts)
    log("phase 33 post-sort dynamic keys:")
    post = phase_post_sort(torch, trainer, batch100, args.profile_steps, args.seed, zero_counts,
                           read_counts, share)
    log("phase 34 bf16 on dynamic keys:")
    dyn16 = phase_dynamic_bf16(torch, trainer, batch100, args.profile_steps, args.seed,
                               zero_counts, read_counts)
    log("phase 35 use_ckpt:")
    ckpt = phase_ckpt(torch, trainer, batch_np, batch100, args.seed)
    log("phase 36 the static-plan family:")
    fam = phase_static_family(torch, trainer, batch100, batch_np, args.profile_steps, args.seed,
                              zero_counts, read_counts)
    runs32_34 = {"32 zero-padded parity": zero["parity"], **{f"33 {k}": v for k, v in post.items()},
                 "34 share_heads bf16": dyn16, "34 share_heads bf16 gather_sort":
                 dyn16["gather_sort"]}
    for key, names in (("K6", ("cols_fwd", "cols_fwd_tc")), ("K7", ("cols_bwd", "cols_bwd_tc"))):
        rows[key]["dynamic_launches"] = {k: {n: r["launches"][n] for n in names}
                                         for k, r in runs32_34.items()}
        rows[key]["dynamic_launches_in"] = (f"phases 32-34, {args.profile_steps} steps a run, "
                                            "by route counter")
    for key, name in (("K1", "bucket_attn_fwd_tc"), ("K2", "bucket_attn_bwd_tc")):
        rows[key]["zero_padding_launches"] = zero["hept_acc"]["launches"][name]
        rows[key]["zero_padding_launches_in"] = "phase 32, one zero-padded hept_acc step"
    for key, run in (("K5g", "33 per-head post-sort gather_sort"),
                     ("K5gb", "34 share_heads bf16 gather_sort")):
        rows[key]["launches"] = runs32_34[run]["launches"]["row_gather"]
        rows[key]["launches_in"] = (f"phase {run}, {args.profile_steps} steps (the [x | coords] "
                                    "gathers and the unsort's, forward and backward)")
    rows["K5p"]["dynamic_launches"] = {k: r["launches"]["row_gather"] for k, r in
                                       runs32_34.items()}
    rows["K5p"]["dynamic_launches_in"] = f"phases 32-34, {args.profile_steps} steps a run"
    log(f"phase dynamic keys ({smi}): run | step ms (median after the first) | busy ms | "
        "peak GiB | K5 a step")
    for k, r in runs32_34.items():
        busy = "not profiled" if r["busy_ms"] is None else f"{r['busy_ms']:.2f}"
        log(f"  {k} | {r['steady_ms']:.1f} | {busy} | {r['peak_gib']:.2f} | "
            f"{r['launches']['row_gather'] // args.profile_steps}")
    log(f"  32 zero-padded hept_acc | {zero['hept_acc']['steady_ms']:.1f} (one step) | not "
        f"profiled | {zero['hept_acc']['peak_gib']:.2f} | {zero['hept_acc']['launches']['row_gather']}")
    log(f"  34 bf16 gradient vs autograd: relative L2 {dyn16['gradient']['whole_rel_l2']:.3e}, "
        f"worst tensor {dyn16['gradient']['worst']} {dyn16['gradient']['worst_ratio']:.3e}")
    log(f"phase use_ckpt ({smi}): profile | peak GiB plain / use_ckpt | first step ms plain / "
        "use_ckpt")
    for k, r in ckpt.items():
        log(f"  {k} | {r['peak_gib']:.3f} / {r['ckpt_peak_gib']:.3f} | {r['ms']:.1f} / "
            f"{r['ckpt_ms']:.1f}")

    fam_runs = [k for k in fam if "launches" in fam[k]]
    for key, names in (("K6", ("cols_fwd_tc",)), ("K7", ("cols_bwd",)),
                       ("K1", ("bucket_attn_fwd_tc",)), ("K2", ("bucket_attn_bwd_tc",))):
        rows[key]["static_family_launches"] = {
            k: {n: fam[k]["launches"][n] for n in names} for k in fam_runs
            if fam[k]["launches"].get(names[0])}
        rows[key]["static_family_launches_in"] = (f"phase 36, {args.profile_steps} steps a "
                                                  "run")
    for key, run in (("K5h50", "static"), ("K5g2r", "nh2r8bs512cv2rg2"),
                     ("K5g4r", "nh2r8bs512cv2rg4"), ("K5e96", "full")):
        rows[key]["launches"] = fam[run]["launches"]["row_gather"]
        rows[key]["launches_in"] = (f"phase 36, {args.profile_steps} {run} steps (all of the "
                                    "run's row gathers, every width)")
    rows["K5p"]["static_family_launches"] = {k: fam[k]["launches"]["row_gather"]
                                             for k in fam_runs}
    log(f"phase static family ({smi}): run | step ms (median after the first) | busy ms | "
        "peak GiB | K5 a step")
    for k in fam_runs:
        r = fam[k]
        log(f"  {k} | {r['steady_ms']:.1f} | {r['busy_ms']:.2f} | {r['peak_gib']:.2f} | "
            f"{r['launches']['row_gather'] // args.profile_steps}")

    # 37. post-sort keys under head / hash TP, use_ckpt under sharding, zero
    # padding under the bucket SP
    log("phase 37 the sharded modes:")
    sh37 = phase_sharded_modes(torch, trainer, batch100, args.seed, zero_counts, read_counts)
    for key, names in (("K6", ("cols_fwd", "cols_fwd_tc")), ("K7", ("cols_bwd", "cols_bwd_tc")),
                       ("K5p", ("row_gather",))):
        rows[key]["sharded_launches"] = {
            k: [{n: ln.get(n, 0) for n in names} for ln in per_rank]
            for k, per_rank in sh37["launches"].items()}
        rows[key]["sharded_launches_in"] = ("phase 37, one step of each run, by rank (two gloo "
                                            "ranks on one card)")
        rows[key]["sharded_nccl_launches"] = {k: {n: ln.get(n, 0) for n in names}
                                              for k, ln in sh37["nccl"].items()}
        rows[key]["sharded_nccl_launches_in"] = "phase 37, one world-1 bucket step a run"
    log(f"phase sharded modes ({smi}): run | ms by rank (first, warm) | launches rank 0")
    for k, ms in sh37["ms"].items():
        log(f"  {k} | {[[round(x, 1) for x in m] for m in ms]} | {sh37['launches'][k][0]}")
    log("  use_ckpt peak GiB a rank (plain, use_ckpt): " + "; ".join(
        f"{arm} {[tuple(round(x, 3) for x in r) for r in v]}" for arm, v in sh37["ckpt"].items()))

    # 38. attn_impl "xla" and the bare configs' defaults
    log("phase 38 attn_impl xla and the default configs:")
    xla = phase_xla_impl(torch, trainer, batch100, args.profile_steps, args.seed, zero_counts,
                         read_counts)
    for key, names in (("K6", ("cols_fwd", "cols_fwd_tc")), ("K7", ("cols_bwd", "cols_bwd_tc"))):
        rows[key]["xla_launches"] = {k: {n: r["launches"][n] for n in names}
                                     for k, r in xla.items()}
        rows[key]["xla_launches_in"] = (f"phase 38, {args.profile_steps} steps a run (the bare "
                                        "configs' runs: one step), by route counter")
    log(f"phase xla ({smi}): run | step ms (median after the first) | busy ms | peak GiB | "
        "K6 / K7 a step")
    for k, r in xla.items():
        busy = "not profiled" if r["busy_ms"] is None else f"{r['busy_ms']:.2f}"
        n_steps = len(r["metrics"])
        log(f"  {k} | {r['steady_ms']:.1f} | {busy} | {r['peak_gib']:.2f} | "
            + ", ".join(f"{n} {r['launches'][n] // n_steps}"
                        for n in ("cols_fwd", "cols_fwd_tc", "cols_bwd", "cols_bwd_tc")
                        if r["launches"][n]))

    # K11 (row_gather_vreg) has K5's contract and runs on K5's kernel
    rows["K11"] = dict(rows["K5"], name="K11 row_gather_vreg", ported_by="K5",
                       replaces="hept_tpu/ops/gather_pallas.py:124")

    log(json.dumps({"kernels": [
        {**{k: rows[key][k] for k in KERNEL_KEYS},
         **{k: v for k, v in rows[key].items() if k not in KERNEL_KEYS}}
        for key in ("K1", "K2", "K3", "K3d1", "K4", "K5", "K5f32", "K5p", "K5q", "K5v", "K5g",
                    "K5gb", "K5h50", "K5g2r", "K5g4r", "K5e96", "K6", "K7", "K6d28", "K7d28",
                    "K8", "K9", "K10f", "K10b", "K11", "K12")]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
