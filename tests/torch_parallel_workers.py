"""Rank processes of `test_torch_parallel.py`, `test_torch_dsort.py`,
`test_torch_bucket_sp.py`, `test_torch_tp_post_sort.py` and
`test_torch_bucket_padding.py` (imports torch and the port, never JAX):
`python tests/torch_parallel_workers.py TASK RANK WORLD DIR`.

Each rank joins a gloo group through `DIR/rendezvous` (a file, so that test
processes running side by side never race for a port), reads the test's
inputs from `DIR/inputs.pt`, runs TASK and writes `DIR/out_<rank>.pt`.
"""

import datetime
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hept_tpu_torch.parallel import tp  # noqa: E402
from hept_tpu_torch.parallel.dp import shard_batch  # noqa: E402
from hept_tpu_torch.parallel.mesh import TP_AXES, make_mesh  # noqa: E402
from hept_tpu_torch.parallel.sp import head_sharded_attention  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402


def _step(inp, mesh, model, optimizer):
    cfg = ExperimentConfig(**inp["exp"])
    b = shard_batch(inp["batch"], mesh.rank("data"), mesh.size("data"))
    return trainer.train_step(model, optimizer, trainer.make_loss_fn(cfg),
                              trainer.batch_to_device(b, "cpu"), None, 0.0, cfg.batch_mode,
                              mesh.group("data"),
                              tp.sharded_global_norm(mesh) if "sizes" in inp else None)


def dp_task(inp, rank):
    """One data-parallel Adam step; every rank's result."""
    mesh = make_mesh(None, ("data",), device="cpu")
    cfg = ExperimentConfig(**inp["exp"])
    model = trainer.build_model(cfg, inp["in_dim"], inp["coords_dim"], None, "cpu")
    model.load_state_dict(inp["state_dict"])
    opt = trainer.make_optimizer(model.parameters(), lr=inp["lr"])
    m = _step(inp, mesh, model, opt)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state_dict": model.state_dict(),
            "exp_avg": {n: opt.state[p]["exp_avg"] for n, p in model.named_parameters()}}


def tp_task(inp, rank):
    """One DP x hash-TP x head-TP SGD step; the whole model after it. Rank
    0 also takes the single-process step on the whole batch (`single`)."""
    cfg = ExperimentConfig(**inp["exp"])
    single = None
    if rank == 0:
        ref = trainer.build_model(cfg, inp["in_dim"], inp["coords_dim"], None, "cpu")
        ref.load_state_dict(inp["state_dict"])
        m = trainer.train_step(ref, torch.optim.SGD(ref.parameters(), lr=inp["lr"]),
                               trainer.make_loss_fn(cfg),
                               trainer.batch_to_device(inp["batch"], "cpu"))
        single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "state_dict": ref.state_dict()}
    mesh = make_mesh(None, TP_AXES, inp["sizes"], device="cpu")
    model = tp.make_tp_model(cfg.model_config(inp["in_dim"], inp["coords_dim"]), mesh, None,
                             "cpu", state_dict=inp["state_dict"])
    opt = torch.optim.SGD(model.parameters(), lr=inp["lr"])
    m = _step(inp, mesh, model, opt)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state_dict": tp.gather_state_dict(model.state_dict(), mesh), "single": single}


def tp_modes_task(inp, rank):
    """Each run of inp["modes"] (key -> {"exp", "state", "batch", "seed",
    "single"}) on one ("data", "hashes", "heads") mesh of inp["sizes"]: one
    SGD step of the TP model from inp["states"][state] on
    inp["batches"][batch], dropout drawn from `seed` (None: none); the
    loss, gradient norm, whole model after the step and the dropout
    generator's state. Rank 0 also takes the single-process step on the
    whole batch where `single` (`single`)."""
    mesh = make_mesh(None, TP_AXES, inp["sizes"], device="cpu")
    res = {}
    for name, mode in inp["modes"].items():
        cfg = ExperimentConfig(**mode["exp"])
        state = inp["states"][mode["state"]]
        batch = inp["batches"][mode["batch"]]
        out = {"single": None}
        if rank == 0 and mode["single"]:
            ref = trainer.build_model(cfg, inp["in_dim"], inp["coords_dim"], None, "cpu")
            ref.load_state_dict(state)
            m = trainer.train_step(ref, torch.optim.SGD(ref.parameters(), lr=inp["lr"]),
                                   trainer.make_loss_fn(cfg),
                                   trainer.batch_to_device(batch, "cpu"))
            out["single"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "state_dict": ref.state_dict()}
        model = tp.make_tp_model(cfg.model_config(inp["in_dim"], inp["coords_dim"]), mesh,
                                 None, "cpu", state_dict=state)
        gen = None if mode["seed"] is None else \
            tp.dropout_generator(mode["seed"], mesh.rank("data"), "cpu")
        b = shard_batch(batch, mesh.rank("data"), mesh.size("data"))
        m = trainer.train_step(model, torch.optim.SGD(model.parameters(), lr=inp["lr"]),
                               trainer.make_loss_fn(cfg), trainer.batch_to_device(b, "cpu"),
                               gen, 0.0, cfg.batch_mode, mesh.group("data"),
                               tp.sharded_global_norm(mesh))
        out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   state_dict=tp.gather_state_dict(model.state_dict(), mesh),
                   gen=None if gen is None else gen.get_state())
        res[name] = out
    return res


def sp_task(inp, rank):
    """head_sharded_attention forward and input gradients."""
    mesh = make_mesh(None, ("heads",), device="cpu")
    q, k, v = (inp[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    out = head_sharded_attention(q, k, v, inp["alpha"], inp["codes"], inp["invalid"],
                                 mesh.group("heads"), block_size=inp["block_size"],
                                 impl="pallas")
    torch.sum(out * inp["cot"]).backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def run_task(inp, rank):
    """A one-epoch run_one_seed over the group."""
    from hept_tpu_torch.data.datasets import make_synthetic_tracking

    ds = make_synthetic_tracking(**inp["dataset"])
    return {"res": trainer.run_one_seed(ExperimentConfig(**inp["exp"]), ds)}


def collectives_task(inp, rank):
    """Each collective's forward and gradient on `inp["device"]` tensors
    (a gloo group: two ranks may share one card)."""
    from hept_tpu_torch.parallel.collectives import (all_gather, all_reduce_fwd, all_to_all,
                                                     broadcast, copy_to_group)

    dev = torch.device(inp["device"])
    group = make_mesh(None, ("heads",), device=dev).group("heads")
    w = torch.arange(12.0, device=dev).reshape(4, 3)
    x = (torch.arange(6.0, device=dev).reshape(2, 3) + 10 * rank).requires_grad_(True)
    gathered = all_gather(x, 0, group)
    (gathered * w).sum().backward()
    z = torch.full((2, 3), rank + 1.0, device=dev, requires_grad=True)
    summed = all_reduce_fwd(z, group)
    (summed * w[:2]).sum().backward()
    u = torch.ones(2, 3, device=dev, requires_grad=True)
    (copy_to_group(u, group) * (rank + 1)).sum().backward()
    b = broadcast(torch.full((3,), 5.0 + rank, device=dev), group)
    a = (torch.arange(6.0, device=dev).reshape(2, 3) + 10 * rank).requires_grad_(True)
    swapped = all_to_all(a, group)
    (swapped * (torch.arange(6.0, device=dev).reshape(2, 3) + 100 * rank)).sum().backward()
    return {k: v.detach().cpu() for k, v in dict(
        gathered=gathered, dx=x.grad, summed=summed, dz=z.grad, du=u.grad, b=b,
        swapped=swapped, da=a.grad,
        on_device=torch.tensor([t.device.type == dev.type
                                for t in (gathered, summed, b, x.grad, u.grad, swapped, a.grad)
                                ])).items()}


def dsort_task(inp, rank):
    """route_local of each case's permutation: this rank's slab forward,
    the payload slab's gradient of sum(out * cot), and the round trip back
    through the inverse permutation."""
    from hept_tpu_torch.parallel.dsort import invert_perm, route_local

    group = make_mesh(None, ("buckets",), device="cpu").group("buckets")
    world = dist.get_world_size()
    res = []
    for case in inp["cases"]:
        perm, payload, cot = case["perm"], case["payload"], case["cot"]
        ne = perm.shape[-1] // world
        sl = slice(rank * ne, (rank + 1) * ne)
        x = payload[..., sl].clone().requires_grad_(True)
        out = route_local(perm, x, group, case["cap"])
        (out * cot[..., sl]).sum().backward()
        back = route_local(invert_perm(perm), out.detach(), group, case["cap"])
        res.append({"out": out.detach(), "grad": x.grad, "back": back})
    return res


def _bucket_core(inp, group):
    """bucket_sharded_core in each mode of inp["modes"] (transport, cap
    factor): the output and the gradients of sum(out * cot) by the six float
    inputs (none where the output is not finite: the overflow case)."""
    from hept_tpu_torch.parallel.bp import make_bucket_sharded_attention

    res = {}
    for name, kw in inp["modes"].items():
        fn = make_bucket_sharded_attention(group, block_size=inp["block_size"], **kw)
        ins = [inp[k].clone().requires_grad_(True)
               for k in ("x", "coords", "wq", "wk", "wv", "sqrt_w")]
        out = fn(*ins, inp["alpha"], inp["codes"], inp["invalid"])
        grads = torch.autograd.grad((out * inp["cot"]).sum(), ins) \
            if torch.isfinite(out).all() else None
        res[name] = {"out": out.detach(), "grads": grads}
    return res


def _bucket_runs(st, mesh):
    """Each run of st["runs"] (key -> {"exp", "transport"}) as one DP x
    bucket-SP Adam step of st["state_dict"] on st["batch"]: loss, grad norm
    and the gradients."""
    from hept_tpu_torch.parallel.bp import make_bucket_model, make_bucket_train_step

    res = {}
    for key, run in st["runs"].items():
        cfg = ExperimentConfig(**run["exp"])
        model = make_bucket_model(cfg.model_config(st["in_dim"], st["coords_dim"]), mesh, None,
                                  "cpu", st["state_dict"], run["transport"], 4.0)
        opt = trainer.make_optimizer(model.parameters(), lr=st["lr"])
        m = make_bucket_train_step(model, opt, trainer.make_loss_fn(cfg), mesh)(
            trainer.batch_to_device(st["batch"], "cpu"))
        res[key] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    return res


def bucket_sp_task(inp, rank):
    """The bucket-axis SP: the layer-level core over all the ranks
    (inp["core"]), then the train step on a ("data", "buckets") mesh of
    inp["step"]["sizes"]."""
    mesh = make_mesh(None, ("buckets",), device="cpu")
    core = _bucket_core(inp["core"], mesh.group("buckets"))
    st = inp["step"]
    step_mesh = make_mesh(None, ("data", "buckets"), st["sizes"], device="cpu")
    runs = {t: {"exp": st["exp"], "transport": t} for t in ("replicated", "distributed")}
    return {"core": core, "step": _bucket_runs(dict(st, runs=runs), step_mesh)}


def bucket_padding_task(inp, rank):
    """The bucket-axis SP on padded events: the layer-level core over all
    the ranks with invalid rows (inp["core"]), then each run of
    inp["step"]["runs"] on a ("data", "buckets") mesh of
    inp["step"]["sizes"]."""
    group = make_mesh(None, ("buckets",), device="cpu").group("buckets")
    core = _bucket_core(inp["core"], group)
    mesh = make_mesh(None, ("data", "buckets"), inp["step"]["sizes"], device="cpu")
    return {"core": core, "step": _bucket_runs(inp["step"], mesh)}


TASKS = {"dp": dp_task, "tp": tp_task, "tp_modes": tp_modes_task, "sp": sp_task,
         "run": run_task, "collectives": collectives_task, "dsort": dsort_task,
         "bucket_sp": bucket_sp_task, "bucket_padding": bucket_padding_task}


def main():
    task, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    inp = torch.load(d / "inputs.pt", weights_only=False)
    out = TASKS[task](inp, rank)
    torch.save(out, d / f"out_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
