"""Design probe for K12, the per-row sort (`csrc/sort.cu`), on one GPU.

    python -m hept_tpu_torch.scripts.k12_probe [--rows 24] [--n 60000] [--ops 16]

Builds `k12_probe.cu` (which includes `csrc/sort.cu`) with nvcc, then on
keys made as chip_smoke.py's K12 phase makes them times by CUDA graph
replay: the whole call through `bitonic_sort_rows_cuda` (the cluster route
at n <= 65536), its two kernels apart (the sort, the staged gather), and the
designs they were chosen over (see the .cu): the first cut of the sort, the
payload move through distributed shared memory at several cluster shapes
(CTAs a row x payloads a cluster) and the gather through L2. Each variant's
output is checked bit for bit (the sorts' positions against each other, the
payloads against `bitonic_sort_rows_plain`). Prints the card's name and
power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from functools import partial
from pathlib import Path

import torch

from ..ops import cuda_lib
from ..ops import sort as srt

SRC = Path(__file__).resolve().with_suffix(".cu")
MOVE_SHAPES = ((2, 1), (4, 1), (4, 2))  # (CTAs a row, payloads a cluster)


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of one call of `fn`, `iters` calls captured in one CUDA graph."""
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


def build() -> ctypes.CDLL:
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = cuda_lib.BUILD_DIR / "libk12_probe.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(SRC)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("probe_sort", [p, p, i, i, p, i, p]),
                       ("probe_gather", [p, p, p, i, i, i, i, p]),
                       ("probe_invert", [p, p, i, i, p]),
                       ("probe_move", [p, p, p, i, i, i, i, i, p]),
                       ("probe_marks", [p, i]),
                       ("probe_overlap", [p, p, p, i, i, i, i, p, p])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args
    return lib


MARKS = 17
PHASES = {"load": (0, 1), "thread_and_warp_sort": (1, 2), "cta_merges": (2, 3),
          **{f"round{r}_{name}": (4 * r + a, 4 * r + b) for r in range(3)
             for name, a, b in (("split", 4, 5), ("copy", 5, 6), ("merge", 6, 7))},
          **{f"round{r}_wait": (4 * r + 3, 4 * r + 4) for r in range(3)},
          "write": (3, 16), "total": (0, 16)}


def sort_phases(lib, keys, tie, perm, rows, n, run) -> dict:
    """Mean SM cycles of each phase of one sort launch over its CTAs (thread
    0's clock at the phase marks of csrc/sort.cu); a round's "wait" runs
    from the end of the previous phase to the cluster barrier's release."""
    import numpy as np

    run("probe_sort", keys.data_ptr(), tie.data_ptr(), rows, n, perm.data_ptr(), 0)
    torch.cuda.synchronize()
    c = 1
    while c * 8192 < n:
        c <<= 1
    ctas = rows * c
    marks = (ctypes.c_longlong * (ctas * MARKS))()
    if lib.probe_marks(marks, ctas * MARKS):
        raise RuntimeError("probe_marks failed")
    m = np.frombuffer(marks, dtype=np.int64).reshape(ctas, MARKS).astype(np.float64)
    rounds = (c - 1).bit_length()
    out = {}
    for name, (a, b) in PHASES.items():
        if name.startswith("round") and int(name[5]) >= rounds:
            continue
        if name == "write" and rounds:
            a = 4 * rounds + 3
        out[name] = float(np.mean(m[:, b] - m[:, a]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=24)
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--ops", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows, n, ops = args.rows, args.n, args.ops
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    keys = torch.randn((rows, n), generator=gen, device=dev)
    keys[:, -min(n, 600):] = 3.0e38
    keys[:, :2000] = torch.round(keys[:, :2000] * 10) / 10
    keys[:, :4] = torch.tensor([-0.0, 0.0, -0.0, 0.0], device=dev)[:n]
    pays = [torch.randint(-2**31, 2**31 - 1, (rows, n), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(ops - 1)]
    pays.append(torch.arange(n, device=dev, dtype=torch.int32).expand(rows, n).contiguous())
    want = srt.bitonic_sort_rows_plain(keys, pays)
    outs = [torch.empty_like(p) for p in pays]
    ins_arr = (ctypes.c_void_p * ops)(*(p.data_ptr() for p in pays))
    outs_arr = (ctypes.c_void_p * ops)(*(o.data_ptr() for o in outs))
    rank = torch.empty((rows, n), dtype=torch.int32, device=dev)
    perm = torch.empty((rows, n), dtype=torch.int16, device=dev)

    def run(name, *a):
        err = getattr(lib, name)(*a, cuda_lib.stream_ptr(dev))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def exact(label):
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip(outs, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: payload {j} differs in {int((a != b).sum())}")
        for o in outs:
            o.fill_(-1)

    got = srt.bitonic_sort_rows_cuda(keys, pays)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("bitonic_sort_rows_cuda differs from the plain version")
    res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip(),
           "rows": rows, "n": n, "ops": ops, "route": srt.sort_route(rows, n, ops),
           "call_ms": graph_ms(lambda: srt.bitonic_sort_rows_cuda(keys, pays)),
           "bound_ms": 4.0 * rows * n * (1 + 2 * ops) / 3.35e12 * 1e3}
    for key, first_cut in (("sort_ms", 0), ("first_cut_sort_ms", 1)):
        sort = partial(run, "probe_sort", keys.data_ptr(), pays[-1].data_ptr(), rows, n,
                       perm.data_ptr(), first_cut)
        sort()
        torch.cuda.synchronize()
        if first_cut and not torch.equal(perm, want_perm):
            raise AssertionError("the first-cut sort's positions differ")
        want_perm = perm.clone()
        res[key] = graph_ms(sort)
    res["sort_phase_cycles"] = sort_phases(lib, keys, pays[-1], perm, rows, n, run)
    for split in (rows // 3, rows // 2, 2 * rows // 3):
        overlap = partial(run, "probe_overlap", keys.data_ptr(), ins_arr, outs_arr, ops, rows, n,
                          split, perm.data_ptr())
        overlap()
        exact(f"overlap {split}")
        res[f"overlap_{split}_ms"] = graph_ms(overlap)
    for key, l2 in (("gather_ms", 0), ("l2_gather_ms", 1)):
        gather = partial(run, "probe_gather", perm.data_ptr(), ins_arr, outs_arr, ops, rows, n,
                         l2)
        gather()
        exact(key)
        res[key] = graph_ms(gather)
    run("probe_invert", perm.data_ptr(), rank.data_ptr(), rows, n)
    res["invert_ms"] = graph_ms(partial(run, "probe_invert", perm.data_ptr(), rank.data_ptr(),
                                        rows, n))
    for move_c, p in MOVE_SHAPES:
        move = partial(run, "probe_move", rank.data_ptr(), ins_arr, outs_arr, ops, rows, n,
                       move_c, p)
        move()
        exact(f"move {move_c}x{p}")
        res[f"dsmem_move_{move_c}x{p}_ms"] = graph_ms(move)
    print(res["card"])
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
