"""One run of one cell of the port's benchmark: inputs from the seed, the
port's set-up, the measured window, the traced capture after it, and the
comparison with the plain reference that decides `correct`.

This module is general. Everything that belongs to one configuration,
traffic mix, loop, metric or cell lives in a file of its own, found by the
name `BENCHMARK.json` or the traffic file gives it:
`configs/<config>.json` and `reference/<config>.py` (the plain reference:
`param_spec`, `train_reference`, `eval_reference`, `PRECISIONS`);
`traffic/<traffic>.json` (data), which names its `generator`
(`generators/<generator>.py`: `make_batches`, `to_device`, the faults'
`half_batch`) and its `loop` (`loops/<loop>.py`: `Loop`, the set-up, the
window's step and the comparison); `e2e_metrics/<metric>.py` and
`layer_metrics/<metric>.py` (`read(record)`); `limits/<workload>.json`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import flops
from .kernel_names import port_kernel
from .weights import make_weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hept_tpu")
# a window step taken after this share of the window is "late": the
# training loop compares one such step with the reference
LATE = 0.75


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark_spec() -> dict:
    return load_json(ROOT.parent / "BENCHMARK.json")


def cell_files(workload: str, spec: dict | None = None) -> dict:
    """The cell's entry and the files it names, found by name."""
    spec = spec or benchmark_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    traffic = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    pkg = __package__
    return {"cell": cell,
            "config": load_json(ROOT / "configs" / f"{cell['config']}.json"),
            "traffic": traffic,
            "limits": load_json(ROOT / "limits" / f"{workload}.json"),
            "reference": importlib.import_module(f"{pkg}.reference.{cell['config']}"),
            "generator": importlib.import_module(f"{pkg}.generators.{traffic['generator']}"),
            "loop": importlib.import_module(f"{pkg}.loops.{traffic['loop']}")}


def metric_reader(section: str, name: str):
    """`read(record) -> float | None` of e2e_metrics/<name>.py or
    layer_metrics/<name>.py."""
    folder = "e2e_metrics" if section == "end_to_end" else "layer_metrics"
    path = ROOT / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"{folder}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, section: str) -> list:
    """The metrics of `section` that this cell reports: every per-layer
    metric lists its cells; an end-to-end metric without `workloads` is
    every cell's."""
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, flax's or
    the JAX package's, compared whole (the port's name begins with the JAX
    package's)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def seeds(seed: int) -> dict:
    s = np.random.SeedSequence(seed).generate_state(4, np.uint64)
    return {"events": int(s[0]), "aug": int(s[1]), "weights": int(s[2] >> 1),
            "dropout": int(s[3] >> 1)}


def port_config(cfg: dict):
    from hept_tpu_torch.train.config import ExperimentConfig

    keys = ("task", "model_name", "model_kwargs", "attn_impl", "padding_mode", "loss_name",
            "loss_kwargs", "optimizer_name", "optimizer_kwargs", "batch_size", "batch_mode",
            "windowed_pairs")
    return ExperimentConfig(**{k: cfg[k] for k in keys})


class Clock:
    """Seconds since the process started (the kernel's start time of this
    process, so the interpreter's own start-up counts too)."""

    def __init__(self):
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        self.t0 = start / ticks

    def now(self) -> float:
        return time.clock_gettime(time.CLOCK_BOOTTIME) - self.t0


class Cell:
    """What a loop gets: the cell's files, its inputs and weights from the
    seed, the device and the run's options."""

    def __init__(self, workload, seed, device, trace, fault, control, overrides, log, clock):
        f = cell_files(workload)
        self.workload, self.trace, self.fault, self.control = workload, trace, fault, control
        self.cfg, self.limits = f["config"], f["limits"]
        self.traffic = dict(f["traffic"], **(overrides or {}))
        self.reference, self.generator = f["reference"], f["generator"]
        self.loop_module = f["loop"]
        self.device, self.log, self.clock = device, log, clock
        self.pcfg = port_config(self.cfg)
        self.seeds = seeds(seed)
        self.host_batches = self.generator.make_batches(self.cfg, self.traffic, self.seeds)
        log(f"set-up: {len(self.host_batches)} batches generated and packed {clock.now():.3f} s")
        self.weights = make_weights(self.reference.param_spec(self.cfg), self.cfg,
                                    self.seeds["weights"], device)

    def build_model(self):
        """The port's model of the configuration, holding the seed's weights."""
        from hept_tpu_torch.train import trainer

        model = trainer.build_model(self.pcfg, self.cfg["in_dim"], self.cfg["coords_dim"], None,
                                    self.device)
        model.load_state_dict(self.weights, strict=True)
        return model

    def reference_batches(self) -> list:
        return [self.generator.to_device(b, self.device) for b in self.host_batches]


class Capture:
    """One torch.profiler capture of CUDA activity only (no CPU ops, so the
    host is not slowed), between two synchronisations: device busy time,
    each device op's total, and the idle gaps labelled by the op that ends
    them."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.steps = 0

    def start(self):
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            trace = json.loads(Path(path).read_text())
        finally:
            Path(path).unlink(missing_ok=True)
        self.prof = None
        ops = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
               for e in trace.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not ops:
            raise RuntimeError("the profiler recorded no device activity")
        ops.sort()
        busy, gaps, totals = 0.0, {}, {}
        cur_s, cur_e = ops[0][0], ops[0][1]
        for s, e, name in ops:
            totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
            if s > cur_e:
                busy += cur_e - cur_s
                label = f"before {name[:80]}"
                gaps[label] = gaps.get(label, 0.0) + (s - cur_e) * 1e-6
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        return {"busy_s": busy * 1e-6, "steps": self.steps, "ops": totals, "gaps": gaps}


def timed_window(seconds: float, step, events_timing: bool):
    """Call step(i, late) back to back until `seconds` of host time have
    passed and at least one step was late (begun after LATE of the window),
    then synchronise. A CUDA event on the stream at every step boundary
    times each step on the device's clock. Returns (steps, window seconds,
    per-step ms, host dispatch ms a step)."""
    marks, dispatch = [], []
    t_open = time.perf_counter()
    i, any_late = 0, False
    while True:
        if events_timing:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            marks.append(mark)
        t0 = time.perf_counter()
        late = t0 - t_open >= LATE * seconds
        any_late |= late
        step(i, late)
        dispatch.append((time.perf_counter() - t0) * 1e3)
        i += 1
        if any_late and time.perf_counter() - t_open >= seconds:
            break
    if events_timing:
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
        torch.cuda.synchronize()
    window = time.perf_counter() - t_open
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return i, window, step_ms, dispatch


def captured(device, seconds: float, step, first: int) -> dict:
    """The traced run's capture, after its window: the same loop goes on
    (step(first), step(first + 1), ...) for `seconds` of host time, at least
    three steps, under the profiler. CUPTI slows the host's launches there,
    so the capture gives device time by op and busy time a step, and the
    unprofiled window gives the time a step."""
    cap = Capture(device)
    cap.start()
    t0 = time.perf_counter()
    while cap.steps < 3 or time.perf_counter() - t0 < seconds:
        step(first + cap.steps, False)
        cap.steps += 1
    return cap.stop()


class Record:
    """What the metric readers read: the window (steps, events, seconds,
    host dispatch ms and device-clock ms of each step), the set-up seconds,
    the capture of a traced run (device busy, per-op totals, steps; else
    None), the loop's spans and the shapes."""

    def __init__(self, cell, steps, events, window_s, step_ms, dispatch_ms, setup_s, capture,
                 spans):
        self.workload, self.cfg, self.traffic = cell.workload, cell.cfg, cell.traffic
        self.n = int(cell.host_batches[0]["x"].shape[1])
        self.pairs = statistics.mean(int(b["pairs"].shape[-1]) for b in cell.host_batches)
        self.steps, self.events, self.window_s = steps, events, window_s
        self.step_ms, self.dispatch_ms, self.setup_s = step_ms, dispatch_ms, setup_s
        self.capture, self.spans = capture, spans
        self.port_kernel = port_kernel
        self.flops = flops
        self.busy_per_step_s = capture["busy_s"] / capture["steps"] if capture else None

    def kernel_s(self, ids) -> float:
        """Device seconds in the capture of the port kernels `ids`."""
        return sum(s for name, s in self.capture["ops"].items() if port_kernel(name) in ids)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, fault: str | None = None, control: bool = False,
             log=None) -> dict:
    """One run. `overrides` change traffic fields (CPU tests only);
    `fault` plants a fault in the timed path (the control tests): "frozen"
    (the optimizer leaves the state unchanged), "half_batch" (the loss over
    half of the pairs), "half_split" (eval skips half of the batches),
    "altered" (eval embeddings of 1 % of the rows replaced). `control` adds
    the readings of the reference in the precision below the stated one,
    in the program's place, under "control" (control.py)."""
    clock = Clock()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = benchmark_spec()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from hept_tpu_torch.ops import bucket_attn_cuda, pair_ops, row_gather

    log(f"set-up: imports {clock.now():.3f} s")
    cell = Cell(workload, seed, dev, trace, fault, control, overrides, log, clock)
    loop = cell.loop_module.Loop(cell)
    counters = (bucket_attn_cuda.LAUNCHES, pair_ops.LAUNCHES, row_gather.LAUNCHES)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counts0 = [dict(c) for c in counters]
    setup_s = clock.now()
    log(f"set-up {setup_s:.3f} s; window {seconds} s, {'traced' if trace else 'untraced'}")
    steps, window_s, step_ms, dispatch = timed_window(seconds, loop.step, cuda)
    launches = {k: v - c0[k] for c, c0 in zip(counters, counts0) for k, v in c.items()
                if v != c0[k]}
    capture = captured(dev, min(3.0, 0.25 * seconds), loop.step, steps) if trace else None
    spans = loop.close_window()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    unit = loop.unit
    units = unit + ("es" if unit.endswith("s") else "s")
    log(f"window {window_s:.4f} s, {steps} {units}; launches a {unit}: "
        + json.dumps({k: round(v / steps, 3) for k, v in sorted(launches.items())})
        + f"; peak {peak / 2**30:.3f} GiB")
    if step_ms:
        fifth = max(1, len(step_ms) // 5)
        log(f"{unit} ms median {statistics.median(step_ms):.4f}, by fifth of the window "
            + json.dumps([round(statistics.median(step_ms[i:i + fifth]), 4)
                          for i in range(0, fifth * 5, fifth)]))

    # what the window produced, compared once the program's state is freed
    out = loop.finish()
    record = Record(cell, steps, steps * loop.events_per_step, window_s, step_ms, dispatch,
                    setup_s, capture, spans)
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    section = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(spec, workload, section):
        v = metric_reader(section, m["name"])(record)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        # the device's busy seconds a step, from the capture, over the
        # unprofiled window's steps: the profiler's own launch cost stays out
        result["device"]["busy_s"] = record.busy_per_step_s * steps
        result["device"]["window_s"] = window_s
        top = sorted(capture["ops"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(capture["gaps"].items(), key=lambda kv: -kv[1])[:10]
        k = capture["steps"]
        kids = sorted({port_kernel(nm) for nm in capture["ops"]} - {None})
        other = sum(v for nm, v in capture["ops"].items() if port_kernel(nm) is None)
        log(f"capture: {k} {units}, busy {record.busy_per_step_s * 1e3:.3f} ms each; "
            "ms each by K-id: "
            + json.dumps({kid: round(record.kernel_s((kid,)) / k * 1e3, 4) for kid in kids})
            + f", other {other / k * 1e3:.3f}")
        for name, v in top:
            log(f"  top op {v / k * 1e3:9.4f} ms each: {name[:110]}")
        for name, v in gaps:
            log(f"  idle gap {v / k * 1e3:9.4f} ms each: {name[:110]}")
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    # every number with a limit is compared; a number the cell's limits
    # leave out (no upper reading, PERF.md) is printed beside "null"
    checks, limits = out["checks"], cell.limits
    result["correct"] = bool(out["failed"] == 0
                             and all(k in checks and checks[k] <= limits[k] for k in limits))
    if "control" in out:
        result["control"] = out["control"]
    result["checks"] = {k: {"value": checks.get(k, math.inf), "limit": limits.get(k)}
                        for k in sorted(set(checks) | set(limits))}
    log("details: " + json.dumps(out["extra"], default=float))
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']:.6g} (limit {v['limit']})")
    return result


def nvidia_smi() -> str:
    """The card's name, power limit, clocks and draw, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
