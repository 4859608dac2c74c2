"""The `eval` loop: the body of the port's `train.trainer.evaluate`, pass
after pass over a split of host batches: `model.eval()` under
`torch.inference_mode()`, `batch_to_device` of each host batch,
`make_eval_step(cfg)` on it, and one host read of the losses and metrics a
pass. `evaluate` itself is not called: it packs with the port's own packer.

Compared: every pass's per-batch loss (relative gap) and every event's
nine retrieval metrics (absolute gap), and the last pass's embeddings over
the real rows (relative L2 gap, worst event). A missing answer reads inf.
"""

from __future__ import annotations

import math

import torch


def answer_rows(losses: list, metrics: list) -> torch.Tensor:
    """A pass's answers, one row a batch: [loss | (B, 3, 3) metrics]."""
    return torch.cat([torch.stack(losses)[:, None],
                      torch.stack([m.reshape(-1) for m in metrics])], dim=1)


def compare_eval(got: torch.Tensor, embs: list, want: list, batches: list) -> dict:
    """got (passes, batches, 1 + 9 B); embs: the last pass's (n, out) of
    each event in order; want: the reference's (embeddings, loss, metrics)
    a batch."""
    ref_rows = answer_rows([torch.tensor(loss) for _, loss, _ in want],
                           [m.cpu() for _, _, m in want])
    checks = {"loss_gap": math.inf, "metric_gap": math.inf, "embedding_gap": math.inf}
    if got.shape[0] and got.shape[1:] == ref_rows.shape:
        checks["loss_gap"] = float(((got[..., 0] - ref_rows[:, 0]).abs()
                                    / ref_rows[:, 0].abs()).max())
        checks["metric_gap"] = float((got[..., 1:] - ref_rows[:, 1:]).abs().max())
    pairs = [(emb_r[i], b["valid"][i]) for (emb_r, _, _), b in zip(want, batches)
             for i in range(emb_r.shape[0])]
    if len(embs) == len(pairs):
        checks["embedding_gap"] = max(float((e[v] - r[v]).norm() / r[v].norm())
                                      for e, (r, v) in zip(embs, pairs))
    return checks


class Loop:
    unit = "pass"  # the window's unit of work

    def __init__(self, cell):
        from hept_tpu_torch.train import trainer

        self.cell, self.trainer = cell, trainer
        dev = cell.device
        self.model = cell.build_model()
        self.model.eval()
        cell.log(f"set-up: weights and model {cell.clock.now():.3f} s")
        eval_step = trainer.make_eval_step(cell.pcfg)
        self.outputs = []
        self.model.register_forward_hook(lambda m, i, o: self.outputs.append(o))
        if cell.fault == "altered":
            self.model.register_forward_hook(lambda m, i, o: _alter_rows(o))
        self.spans = {}
        if cell.trace:
            self._spans()
        split = cell.host_batches
        self.split = split[: len(split) // 2] if cell.fault == "half_split" else split
        self.events_per_step = sum(int(b["x"].shape[0]) for b in self.split)
        self.answers = []

        def one_pass():
            self.outputs.clear()
            ls, tms = [], []
            for b in self.split:
                loss, tm = eval_step(self.model, trainer.batch_to_device(b, dev))
                ls.append(loss)
                tms.append(tm)
            return answer_rows(ls, tms).cpu()  # the one host read of a pass

        self.one_pass = one_pass
        self.inference = torch.inference_mode()
        self.inference.__enter__()
        one_pass()  # warm-up

    def step(self, i: int, late: bool):
        self.answers.append(self.one_pass())

    def close_window(self) -> dict:
        self.inference.__exit__(None, None, None)
        self.model._forward_hooks.clear()
        self.model._forward_pre_hooks.clear()
        if not self.cell.trace:
            return {}
        self.trainer.tracking_metrics_batch = self.spans.pop("inner")
        per = self.cell.cfg["batch_size"]  # the metrics run once a batch
        return {"forward_ms": [a.elapsed_time(b) for a, b in self.spans.pop("_f", [])],
                "knn_ms": [a.elapsed_time(b) / per for a, b in self.spans.pop("_k", [])]}

    def finish(self) -> dict:
        cell = self.cell
        attempted = len(self.answers) * sum(int(b["x"].shape[0]) for b in cell.host_batches)
        got = torch.stack(self.answers) if self.answers else torch.zeros((0, 0, 0))
        finite = torch.isfinite(got).all(dim=-1).sum() * cell.cfg["batch_size"]
        failed = attempted - int(finite)
        embs = [o.detach().float() for o in self.outputs]
        del self.model, self.one_pass, self.outputs
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        ref, cfg = cell.reference, cell.cfg
        batches = cell.reference_batches()
        want = ref.eval_reference(cell.weights, cfg, batches)
        out = {"attempted": attempted, "failed": failed,
               "checks": compare_eval(got, embs, want, batches), "extra": {}}
        if cell.control:
            low = ref.eval_reference(cell.weights, cfg, batches, ref.PRECISIONS[cfg["control"]])
            rows = answer_rows([torch.tensor(loss) for _, loss, _ in low],
                               [m.cpu() for _, _, m in low])[None]
            out["control"] = compare_eval(rows, [e[i] for e, _, _ in low
                                                 for i in range(e.shape[0])], want, batches)
        return out

    def _spans(self):
        """CUDA-event spans around the forward (model hooks) and around the
        tracking metrics (a wrapper of the trainer's module attribute), in ms
        an event, read after the window."""
        marks, spans, trainer = {}, self.spans, self.trainer

        def pre(m, i):
            marks["f0"] = torch.cuda.Event(enable_timing=True)
            marks["f0"].record()

        def post(m, i, o):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.setdefault("_f", []).append((marks["f0"], e))

        self.model.register_forward_pre_hook(pre)
        self.model.register_forward_hook(post)
        inner = trainer.tracking_metrics_batch

        def metrics(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            s.record()
            out = inner(*a, **k)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.setdefault("_k", []).append((s, e))
            return out

        spans["inner"] = inner
        trainer.tracking_metrics_batch = metrics


def _alter_rows(out):
    """A fault: replace 1 % of the rows of the embeddings by their
    neighbours'."""
    n = out.shape[-2]
    idx = torch.arange(0, n, 100, device=out.device)
    out[..., idx, :] = out[..., (idx + 1) % n, :]
    return out
