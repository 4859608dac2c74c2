"""The `train` loop: the port's `train_step` back to back, one packed batch
a step, cycling over the traffic's pool of batches, dropout on as trained.

Set-up builds the one model and optimizer that the window drives, takes
the first three steps through the window's own call on three different
batches, then a warm-up pass over the pool. The reference follows those
three steps from the seed. Inside the window, the first step begun after
`harness.LATE` of it is snapshotted (parameters, Adam's state, the dropout
generator's state before it; parameters and Adam's first moment after it),
and the reference takes that step again from the program's snapshot.

Compared, each by the worst counted leaf of |norm(port) - norm(reference)|
/ max(norm(reference), the median leaf's norm) where a leaf is meant:
- the set-up's first loss (relative gap), first gradient (Adam's exp_avg /
  (1 - b1)) and the parameters' change over the three steps;
- the late window step's loss gap over the set-up's first reference loss
  (the loss itself has fallen near 0 there, three batches seen a thousand
  times, and its relative gap swings with it), gradient ((exp_avg after -
  b1 exp_avg before) / (1 - b1)) and parameter change.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out: they move under Adam by round-off alone.
"""

from __future__ import annotations

import statistics

import torch

ADAM_B1 = 0.9


def leaf_gap(prog: dict, ref_: dict, keep: list) -> tuple[float, str]:
    """Worst leaf of |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm), over the leaves `keep`."""
    norms = {k: float(ref_[k].norm()) for k in keep}
    med = statistics.median(norms.values())
    worst, at = 0.0, ""
    for k in keep:
        g = abs(float(prog[k].float().norm()) - norms[k]) / max(norms[k], med)
        if g > worst:
            worst, at = g, k
    return worst, at


def counted_leaves(grads: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def compare_steps(start: dict, prog: tuple, want: tuple, prefix: str = "",
                  loss_scale: float | None = None) -> tuple[dict, dict]:
    """prog / want: (losses, first gradients, parameters after the last
    step), from the parameters `start`. The first loss's gap over
    `loss_scale` (none: over the reference's loss), the first gradient's and
    the parameters' change's worst leaf."""
    keep = counted_leaves(want[1])
    delta_p = {k: prog[2][k] - start[k] for k in keep}
    delta_r = {k: want[2][k] - start[k] for k in keep}
    gaps = [abs(a - b) / abs(loss_scale or b) for a, b in zip(prog[0], want[0])]
    checks = {f"{prefix}loss_gap" if prefix else "first_loss_gap": gaps[0]}
    checks[f"{prefix}grad_gap"], g_at = leaf_gap(prog[1], want[1], keep)
    checks[f"{prefix}update_gap"], u_at = leaf_gap(delta_p, delta_r, keep)
    extra = {f"{prefix}loss_gaps": gaps, f"{prefix}losses": prog[0],
             f"{prefix}reference_losses": want[0], f"{prefix}grad_gap_leaf": g_at,
             f"{prefix}update_gap_leaf": u_at, f"{prefix}leaves_counted": len(keep),
             f"{prefix}leaves_left_out": sorted(set(want[1]) - set(keep))}
    return checks, extra


class Loop:
    unit = "step"  # the window's unit of work

    def __init__(self, cell):
        from hept_tpu_torch.train import trainer
        from hept_tpu_torch.train.optim import make_optimizer

        self.cell = cell
        cfg, dev, log = cell.cfg, cell.device, cell.log
        if len(cell.host_batches) < 3:
            raise ValueError("the train loop compares three steps on different batches")
        self.events_per_step = cfg["batch_size"]
        self.batches = [trainer.batch_to_device(b, dev) for b in cell.host_batches]
        self.model = cell.build_model()
        loss_fn = trainer.make_loss_fn(cell.pcfg)
        if cell.fault == "half_batch":
            loss_fn = cell.generator.half_batch(loss_fn)
        self.opt = make_optimizer(self.model.parameters(), cfg["optimizer_name"],
                                  cfg["optimizer_kwargs"]["lr"])
        if cell.fault == "frozen":
            self.opt.step = lambda *a, **k: None
        self.gen = torch.Generator(device=dev).manual_seed(cell.seeds["dropout"])
        self.gen_state0 = self.gen.get_state()
        self.names = [k for k, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]

        def call(b):
            return trainer.train_step(self.model, self.opt, loss_fn, self.batches[b], self.gen,
                                      batch_mode=cfg["batch_mode"])

        self.call = call
        log(f"set-up: weights and model {cell.clock.now():.3f} s")
        n_b = len(self.batches)
        self.first_losses, self.first_grads, self.after3 = [], None, None
        # the compared steps: the window's own call on the pool's first three
        # batches; then a warm-up pass over the pool
        for s in range(3 + n_b):
            out = call(s % n_b)
            if s < 3:
                self.first_losses.append(out["loss"])
            if s in (0, 2 + n_b):
                log(f"set-up: step {s + 1} dispatched {cell.clock.now():.3f} s")
            if s == 0:
                self.first_grads = {k: v / (1 - ADAM_B1) for k, v in self._moments()[0].items()}
            if s == 2:
                self.after3 = self._params()
        self.next = (3 + n_b) % n_b
        self.losses, self.snap = [], None

    def _params(self) -> dict:
        return {k: p.detach().clone() for k, p in zip(self.names, self.params)}

    def _moments(self) -> tuple[dict, dict, int]:
        """Adam's exp_avg and exp_avg_sq (zeros where it holds none) and its
        step count."""
        m, v, t = {}, {}, 0
        for k, p in zip(self.names, self.params):
            st = self.opt.state.get(p, {})
            m[k] = st["exp_avg"].detach().clone() if st else torch.zeros_like(p)
            v[k] = st["exp_avg_sq"].detach().clone() if st else torch.zeros_like(p)
            t = int(st["step"]) if st else t
        return m, v, t

    def step(self, i: int, late: bool):
        b = (self.next + i) % len(self.batches)
        if late and self.snap is None:
            m, v, t = self._moments()
            self.snap = {"batch": b, "gen": self.gen.get_state(), "p": self._params(),
                         "m": m, "v": v, "t": t}
            out = self.call(b)
            self.snap.update(loss=out["loss"], p_after=self._params(),
                             m_after=self._moments()[0])
        else:
            out = self.call(b)
        self.losses.append(out["loss"])

    def close_window(self) -> dict:
        return {}

    def finish(self) -> dict:
        cell = self.cell
        host = torch.stack(self.losses).cpu()
        attempted, failed = len(self.losses), int((~torch.isfinite(host)).sum())
        first_losses = [float(x) for x in self.first_losses]
        snap = self.snap
        snap["loss"] = float(snap["loss"])
        del self.model, self.opt, self.params, self.batches, self.call, self.losses
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        ref, cfg, dev, weights = cell.reference, cell.cfg, cell.device, cell.weights
        batches = cell.reference_batches()
        want = ref.train_reference(weights, cfg, batches[:3], self.gen_state0, dev)
        checks, extra = compare_steps(weights, (first_losses, self.first_grads, self.after3),
                                      want)
        # the late window step, from the program's own state
        start = dict(weights, **snap["p"])
        adam = {"m": snap["m"], "v": snap["v"], "t": snap["t"]}
        grad = {k: (snap["m_after"][k] - ADAM_B1 * snap["m"][k]) / (1 - ADAM_B1)
                for k in snap["m"]}
        prog = ([snap["loss"]], grad, snap["p_after"])
        args = (start, cfg, [batches[snap["batch"]]], snap["gen"], dev)
        want_w = ref.train_reference(*args, adam=adam)
        w_checks, w_extra = compare_steps(start, prog, want_w, "window_", want[0][0])
        checks.update(w_checks)
        extra.update(w_extra, window_step_adam_t=snap["t"] + 1)
        out = {"attempted": attempted, "failed": failed, "checks": checks, "extra": extra}
        if cell.control:
            low = ref.PRECISIONS[cfg["control"]]
            got = ref.train_reference(weights, cfg, batches[:3], self.gen_state0, dev, low)
            ctl = compare_steps(weights, got, want)[0]
            ctl.update(compare_steps(start, ref.train_reference(*args, low, adam=adam), want_w,
                                     "window_", want[0][0])[0])
            out["control"] = ctl
        return out
