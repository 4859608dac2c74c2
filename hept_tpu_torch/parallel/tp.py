"""Head- and hash-sharded tensor parallelism composed with data parallelism
(port of `hept_tpu/parallel/tp.py`).

A mesh of ("data", "hashes", "heads") ranks: events shard over "data", the
attention heads over "heads" and the n_hashes OR rounds over "hashes". Each
rank holds a model built from the local config (`local_config`: its shard's
num_heads and n_hashes) and its slice of the weights (`shard_state_dict`);
it hashes, sorts and attends its own (hash, head) slice, and the only
collectives of a layer are the all-gather of the attention output over
heads before `out_linear` and the sum of the OR-combine over hashes
(`models/attention/hept.py`, `parallel/collectives.py`). The replication
pads follow global hash 0 / head 0 on every shard (`models/transformer.py:
prepare_event`).

The step (`dp.train_step` with this module's `sharded_global_norm`): the
loss of this data rank's events, computed alike on every model rank; the
gradients averaged over the data axis (the model ranks' own shards, the
replicated weights alike everywhere); the global norm over the whole model
(head-sharded gradients' squares summed over the heads group, replicated
ones counted once); clip; the optimizer on every rank. Dropout differs per
data rank and is the same on every model rank (`dropout_generator`).

What JAX's `make_tp_train_step` accepts, and so the port: the dynamic-key
HEPT paths with head and hash sharding in any mix: the pre-sort per-head
keys (the parity `hept` profiles) and the post-sort per-head keys (with or
without shared_sort), each with its modes (gather_sort, the bf16 and fp8
transports, kernel_bf16 / kernel_center, use_ckpt). The post-sort
share_heads keys run under hash sharding only: their `e2lsh_alpha` is one
head wide, sharded over hashes (`shard_dims`), and JAX's shard_map refuses
to split it over heads. The static plan is refused under head sharding
(the same refusal) and under hash sharding (JAX runs it, but a hash shard
keeps the whole replicated `static_alpha` while its AND codes shard, so
its layers' rounds are not the single-device model's):
`TransformerConfig.check_supported`.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from ..models.transformer import HeptTransformer, TransformerConfig
from .collectives import all_reduce_, gather_tensor
from .mesh import Mesh

_HEAD_ROWS = re.compile(r"blocks\.\d+\.(w_[qkv]\.(weight|bias)|w_rpe)")


def shard_dims(name: str) -> tuple:
    """(dim, axis) pairs a state-dict entry is sharded over, the port's
    counterpart of `param_specs` (`hept_tpu/parallel/tp.py:34-78`, in
    nn.Linear's (out, in) layout): w_q / w_k / w_v and w_rpe rows over
    heads; e2lsh_alpha (h, d, c) over heads on dim 0 and hashes on dim 2
    (share_heads' one-head alpha splits over hashes alone: it runs with
    one head shard); regions (c, and, h) over hashes on dim 0 and heads on
    dim 2; the rest replicated."""
    if _HEAD_ROWS.fullmatch(name):
        return ((0, "heads"),)
    if name.endswith("attn.e2lsh_alpha"):
        return ((0, "heads"), (2, "hashes"))
    if name == "regions":
        return ((0, "hashes"), (2, "heads"))
    return ()


def shard_state_dict(sd: dict, sizes: dict, coords: dict) -> dict:
    """This rank's slice of a whole state dict (the port's own, or
    `utils/convert.py:from_jax_variables`'s). `sizes` / `coords`: the
    mesh's axis sizes and this rank's coordinates (`Mesh.sizes`,
    `Mesh.coords`)."""
    out = {}
    for k, v in sd.items():
        for dim, axis in shard_dims(k):
            n = sizes.get(axis, 1)
            if v.shape[dim] % n:
                raise ValueError(f"{k} {tuple(v.shape)}: dim {dim} does not divide over {n} "
                                 f"{axis} shards")
            w = v.shape[dim] // n
            v = v.narrow(dim, coords.get(axis, 0) * w, w)
        out[k] = v.contiguous()
    return out


def gather_state_dict(sd: dict, mesh: Mesh) -> dict:
    """The whole state dict from every model rank's slice (inverse of
    `shard_state_dict`; every rank of the mesh must call it)."""
    out = {}
    for k, v in sd.items():
        for dim, axis in reversed(shard_dims(k)):
            v = gather_tensor(v, dim, mesh.group(axis))
        out[k] = v
    return out


def local_config(cfg: TransformerConfig, heads: int, hashes: int) -> TransformerConfig:
    """The model config of one shard, with `make_tp_train_step`'s checks."""
    if cfg.attn_type != "hept":
        raise ValueError("head/hash sharding targets HEPT")
    if cfg.num_heads % heads:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by {heads} head shards")
    if cfg.n_hashes % hashes:
        raise ValueError(f"n_hashes {cfg.n_hashes} not divisible by {hashes} hash shards")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // heads,
                               n_hashes=cfg.n_hashes // hashes, head_shards=heads,
                               hash_shards=hashes)


def make_tp_model(cfg: TransformerConfig, mesh: Mesh, generator=None, device=None,
                  state_dict: dict | None = None) -> HeptTransformer:
    """This rank's shard of the model of `cfg`: the whole model is built
    from `generator` (the same draws on every rank) or taken from
    `state_dict`, and sliced."""
    lcfg = local_config(cfg, mesh.size("heads"), mesh.size("hashes"))
    lcfg.check_supported()
    if state_dict is None:
        state_dict = HeptTransformer(cfg, generator, device).state_dict()
    model = HeptTransformer(lcfg, None, device,
                            {"heads": mesh.group("heads"), "hashes": mesh.group("hashes")})
    model.load_state_dict(shard_state_dict(state_dict, mesh.sizes, mesh.coords))
    return model


def sharded_global_norm(mesh: Mesh):
    """grads -> the whole model's gradient norm, for `dp.train_step`'s
    `sharded_norm`: each sharded gradient's squares summed over the groups
    of its axes, replicated ones counted once."""

    def norm(model, grads):
        names = [n for n, p in model.named_parameters() if p.grad is not None]
        per_axes: dict = {}
        for name, g in zip(names, grads):
            axes = tuple(a for _, a in shard_dims(name))
            per_axes.setdefault(axes, []).append(torch.sum(g * g))
        total = 0.0
        for axes, sq in per_axes.items():
            s = torch.stack(sq).sum()
            for axis in axes:
                all_reduce_(s, mesh.group(axis))
            total = total + s
        return torch.sqrt(total)

    return norm


def dropout_generator(seed: int, data_rank: int, device) -> torch.Generator:
    """The step's dropout generator: one stream per data rank, the same on
    every model rank of it (`tp.py:164-166` folds the data index into the
    key). Data rank 0 takes `seed` itself, so a one-rank run draws as the
    single-process trainer does."""
    return torch.Generator(device=device).manual_seed(seed + 1_000_003 * data_rank)


def _param_names(model) -> list:
    return [n for n, _ in model.named_parameters()]


def _map_optimizer_state(opt_sd: dict, model, fn) -> dict:
    """`fn(name, tensor)` applied to every per-parameter tensor of an
    optimizer state dict whose shape is its parameter's (Adam's moments);
    scalars (`step`) are kept."""
    names = _param_names(model)
    shapes = dict(model.named_parameters())
    state = {}
    for idx, st in opt_sd["state"].items():
        name = names[int(idx)]
        state[idx] = {k: fn(name, v) if torch.is_tensor(v) and v.dim() == shapes[name].dim()
                      and v.dim() > 0 else v for k, v in st.items()}
    return {**opt_sd, "state": state}


def gather_optimizer_state(opt_sd: dict, model, mesh: Mesh) -> dict:
    """The whole model's optimizer state from every model rank's."""
    def whole(name, v):
        for dim, axis in reversed(shard_dims(name)):
            v = gather_tensor(v, dim, mesh.group(axis))
        return v

    return _map_optimizer_state(opt_sd, model, whole)


def shard_optimizer_state(opt_sd: dict, model, mesh: Mesh) -> dict:
    """This rank's slice of a whole model's optimizer state."""
    def local(name, v):
        return shard_state_dict({name: v}, mesh.sizes, mesh.coords)[name]

    return _map_optimizer_state(opt_sd, model, local)
