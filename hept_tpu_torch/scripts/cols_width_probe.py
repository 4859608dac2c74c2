"""Build cost and shared-row strides of the column kernels K6 / K7 at the
pileup width, on one GPU.

    python -m hept_tpu_torch.scripts.cols_width_probe [--parent DIR] [--repeats 2]

1. Times `nvcc` on `csrc/bucket_attn.cu` alone (cuda_lib's flags): this
   tree's, a variant that builds every kernel (K1 / K2 and K10 too) at
   (28, 24), and with `--parent` the one under DIR (a parent tree), in
   turns.
2. Builds a variant of this tree's `bucket_attn.cu` whose FP32 kernels
   stride their shared rows at pad4(w) + 4 words (the strides before
   `stride_4mod8`: 32 words at w = 28, every row in one bank group) and
   times K6 f32 (`cols_fwd_tiled_kernel`) and K7 v1 (`cols_bwd_tiled_kernel`)
   at (r, d, n) = (24, 28, 60000), bs 100, with both builds by CUDA graph
   replay, in turns, checking that both give the same bits.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..ops import bucket_attn_cuda as ba
from ..ops import cuda_lib


def graph_ms(fn, iters: int = 10) -> float:
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


def nvcc_seconds(src: Path, out: Path) -> float:
    t0 = time.perf_counter()
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def old_strides(text: str) -> str:
    """The source with the FP32 kernels' row strides at pad4(w) + 4."""
    subs = ((r"return pad4\(w\) % 8 == 4 \? pad4\(w\) : pad4\(w\) \+ 4;", "return pad4(w) + 4;"),
            (r"stride_4mod8\(round_up\(D, kCC\)\)", "stride_4mod8(D)"),
            (r"stride_4mod8\(round_up\(DV, kCC\)\)", "stride_4mod8(DV)"))
    for pat, rep in subs:
        text, k = re.subn(pat, rep, text)
        if k != 1:
            raise RuntimeError(f"pattern {pat!r} matched {k} times")
    return text


def all_dims(text: str) -> str:
    """The source with (28, 24) in HEPT_DIMS: every launcher at every width."""
    for old, new in (("#define HEPT_DIMS(X) X(30, 24) X(7, 5)\n",
                      "#define HEPT_DIMS(X) X(30, 24) X(7, 5) X(28, 24)\n"),
                     ("#define HEPT_COLS_DIMS(X) HEPT_DIMS(X) X(28, 24)\n",
                      "#define HEPT_COLS_DIMS(X) HEPT_DIMS(X)\n")):
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} not found once")
        text = text.replace(old, new)
    return text


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help="a parent tree's root")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tree_src = cuda_lib.CSRC_DIR / "bucket_attn.cu"
    out: dict = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        srcs = {"tree": tree_src, "all_dims": tmp / "bucket_attn_all_dims.cu"}
        srcs["all_dims"].write_text(all_dims(tree_src.read_text()))
        if args.parent:
            srcs["parent"] = Path(args.parent) / "hept_tpu_torch" / "csrc" / "bucket_attn.cu"
        secs: dict = {k: [] for k in srcs}
        for _ in range(args.repeats):
            for k, src in srcs.items():
                secs[k].append(nvcc_seconds(src, tmp / f"{k}.so"))
        out["bucket_attn_nvcc_s"] = secs

        variant = tmp / "bucket_attn_old_strides.cu"
        variant.write_text(old_strides(tree_src.read_text()))
        nvcc_seconds(variant, tmp / "old.so")
        libs = {"stride_4mod8": ctypes.CDLL(str(tmp / "tree.so")),
                "pad4_plus_4": ctypes.CDLL(str(tmp / "old.so"))}
        gen = torch.Generator(device="cuda").manual_seed(0)
        r, d, dv, n, bs = 24, 28, 24, 60000, 100
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
        sq, sk, sv = rn(r, d, n) * 0.5, rn(r, d, n) * 0.5, rn(r, dv, n)
        gden, gso = rn(r, 1, n), rn(r, dv, n)
        calls = {"K6 f32": lambda: ba.cols_fwd_cuda(sq, sk, sv, bs),
                 "K7 v1": lambda: ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, False)}
        times: dict = {f"{c} {k}": [] for c in calls for k in libs}
        bits: dict = {}
        for _ in range(2):
            for k, lib in libs.items():
                cuda_lib._libs["bucket_attn"] = lib
                for c, fn in calls.items():
                    res = fn()
                    if c in bits and not all(torch.equal(a, b) for a, b in zip(bits[c], res)):
                        raise AssertionError(f"{c}: the two strides give different bits")
                    bits[c] = res
                    times[f"{c} {k}"].append(graph_ms(fn))
        cuda_lib._libs.pop("bucket_attn")
        out["graph_ms_d28"] = times
        out["same_bits"] = True
    print(smi)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
