"""A mesh of named axes over `torch.distributed` ranks (port of
`hept_tpu/parallel/mesh.py`).

The JAX package reshapes its devices into ("data", "hashes", "heads") (its
TP step) or ("data", "buckets") (its bucket-axis SP step) and lets
`shard_map` name the axes. Here every rank is one process: rank r sits at
mesh coordinate (d, hh, h, b) with r = ((d * hashes + hh) * heads + h) *
buckets + b (the row-major order of JAX's `np.reshape` of the device list;
a mesh of ("data", "buckets") alone puts rank d * buckets + b where JAX's
puts device d * buckets + b), and each axis
has one process group per line of the mesh along it, made with `new_group`
on every rank in the same order (torch.distributed's rule). A group of one
rank is made too, so that a one-rank run goes through the same
collectives as a wider one.

Backend: NCCL for a CUDA device, gloo for the CPU, unless the caller names
one (two ranks sharing one card must use gloo: NCCL refuses two ranks on
one device). Nothing falls back to the CPU: a CUDA device that is not
available raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

AXES = ("data", "hashes", "heads", "buckets")
# the TP step's mesh (`parallel/tp.py`)
TP_AXES = ("data", "hashes", "heads")
DEFAULT_TIMEOUT_S = 300


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: `sizes[axis]`, its coordinate
    `coords[axis]` and the process group of its line along each axis."""

    sizes: dict
    coords: dict
    groups: dict
    device: torch.device
    backend: str

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def _check_sizes(n: int, axis_names: tuple, axis_sizes: tuple) -> None:
    """`hept_tpu/parallel/mesh.py:make_mesh`'s checks, with its messages."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names, {len(axis_sizes)} sizes")
    prod = 1
    for s in axis_sizes:
        prod *= s
    if prod != n:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} product {prod} != {n} devices")


def init_distributed(device: torch.device | str, *, rank: int | None = None,
                     world_size: int | None = None, init_method: str | None = None,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group unless it is up already, and return
    this rank's device.

    Rank, world size and the rendezvous come from the arguments, else from
    the `torchrun` environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT,
    LOCAL_RANK). A CUDA device without an index takes cuda:LOCAL_RANK.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for and none is available")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_mesh(n_devices: int | None = None, axis_names: tuple = ("data",),
              axis_sizes: tuple | None = None, *, device: torch.device | str = "cuda",
              **init_kw) -> Mesh:
    """Mesh over the ranks of the default process group (joined first when
    it is not up: `init_distributed`'s keywords).

    1-D over "data" by default; `axis_sizes` gives a multi-axis mesh over
    any of `AXES` (an axis left out has size 1). The
    product of the sizes must equal `n_devices` (None: the world size),
    which must equal the world size: each rank is one device.
    """
    device = init_distributed(device, **init_kw)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"requested {n} devices of a world of {world}: each rank is one "
                         "device, so n_devices must be the world size")
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    _check_sizes(n, tuple(axis_names), tuple(axis_sizes))
    unknown = set(axis_names) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the port's axes are {AXES}")
    named = dict(zip(axis_names, axis_sizes))
    sizes = {a: int(named.get(a, 1)) for a in AXES}
    me = dist.get_rank()
    shape = tuple(sizes[a] for a in AXES)
    coords = dict(zip(AXES, _unravel(me, shape)))
    groups = {}
    for ai, axis in enumerate(AXES):
        mine = None
        # every rank creates every group of the axis, in the same order
        for line in _lines(shape, ai):
            g = dist.new_group(line)
            if me in line:
                mine = g
        groups[axis] = mine
    return Mesh(sizes, coords, groups, device, dist.get_backend())


def _unravel(r: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _lines(shape: tuple, axis: int) -> list:
    """The rank lists of the mesh's lines along `axis`, in a fixed order."""
    import itertools

    others = [range(s) for i, s in enumerate(shape) if i != axis]
    lines = []
    for rest in itertools.product(*others):
        line = []
        for k in range(shape[axis]):
            idx = list(rest)
            idx.insert(axis, k)
            r = 0
            for i, s in zip(idx, shape):
                r = r * s + i
            line.append(r)
        lines.append(line)
    return lines
