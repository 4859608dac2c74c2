"""Carry weights across from the JAX package, and from the reference's
checkpoints (`convert_reference_hept`, `load_reference_checkpoint`).

`from_jax_variables` turns the flax `{"params", "constants"}` tree of a
`hept_tpu` HeptTransformer (static-plan or dynamic-key path; scan or loop
layer layout; tracking or pileup head) into a state dict for
`hept_tpu_torch.models.transformer.HeptTransformer`, and of each of the
seven baseline attentions, and of the four GNN baselines
(`hept_tpu_torch.models.gnns.GNNStack`: a flat tree, `pre_ln_i` / `conv_i`
/ ... per layer, no `block_*` subtrees). It takes any nested mapping of arrays (numpy, or
anything `np.asarray` reads) and imports no JAX. The frozen constants
(`regions` (hept only), `static_alpha` where the model has a static plan,
each layer's `e2lsh_alpha`: (1, ...) on the static plan, (h, d + cd,
n_hashes) with dynamic keys; the baselines' `projection_matrix`,
`favor_omega`, `rff_omega_dr` / `rff_omega_da` and `sb_projection`) are
copied, not redrawn: `jax.random` cannot be reproduced in torch.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layers(tree, n_layers: int | None = None) -> list:
    """Per-layer subtrees: the scan layout {"blocks": {"block": stacked on
    axis 0}} is unstacked; the loop layout is {"block_0": .., ...}."""
    if "blocks" in tree:
        stacked = tree["blocks"]["block"]

        def take(node, i):
            if hasattr(node, "keys"):
                return {k: take(node[k], i) for k in node.keys()}
            return np.asarray(node)[i]

        def depth(node):
            return depth(node[next(iter(node.keys()))]) if hasattr(node, "keys") \
                else np.asarray(node).shape[0]

        return [take(stacked, i) for i in range(depth(stacked))]
    keys = sorted((k for k in tree.keys() if k.startswith("block_")),
                  key=lambda k: int(k.split("_")[1]))
    return [tree[k] for k in keys]


def from_jax_variables(variables, sizes: dict | None = None,
                       coords: dict | None = None) -> dict[str, torch.Tensor]:
    """flax variables -> torch state dict (TorchLinear kernels (in, out)
    become nn.Linear weights (out, in); LayerNorm scale -> weight). With a
    mesh's `sizes` and this rank's `coords` (`parallel/mesh.py:Mesh`), the
    rank's slice for a head / hash sharded model
    (`parallel/tp.py:shard_state_dict`)."""
    if sizes is not None:
        from ..parallel.tp import shard_state_dict

        return shard_state_dict(from_jax_variables(variables), sizes, coords)
    params = variables["params"]
    if "pre_ff_0" in params:
        return _gnn_state_dict(params)
    consts = variables.get("constants", {}) if hasattr(variables, "get") \
        else variables["constants"]
    sd: dict[str, torch.Tensor] = {}

    def lin(prefix, node):
        sd[f"{prefix}.weight"] = _t(node["kernel"]).t().contiguous()
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    def norm(prefix, node):
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    if "pids_enc" in params:  # the pileup task: PID embedding and classifier
        sd["pids_enc.weight"] = _t(params["pids_enc"]["embedding"])
        lin("out_proj", params["out_proj"])
    lin("feat_enc_0", params["feat_enc_0"])
    lin("feat_enc_1", params["feat_enc_1"])
    lin("W", params["W"])
    mlp = params["mlp_out"]
    n_lin = sum(1 for k in mlp.keys() if k.startswith("TorchLinear_"))
    for i in range(n_lin):
        lin(f"mlp_out.lins.{i}", mlp[f"TorchLinear_{i}"])
    for i in range(n_lin - 1):
        norm(f"mlp_out.norms.{i}", mlp[f"LayerNorm_{i}"])
    const_layers = _layers(consts)
    for i, blk in enumerate(_layers(params)):
        p = f"blocks.{i}"
        sd[f"{p}.w_rpe"] = _t(blk["w_rpe"])
        if "pe" in blk:  # the baselines' learned positional embedding
            lin(f"{p}.pe.lin0", blk["pe"]["TorchLinear_0"])
            norm(f"{p}.pe.norm", blk["pe"]["LayerNorm_0"])
            lin(f"{p}.pe.lin1", blk["pe"]["TorchLinear_1"])
        attn = blk["attn"]
        if "block_0" in attn:  # flatformer: four post-norm group layers, no outer block
            for j in range(4):
                src, dst = attn[f"block_{j}"], f"{p}.attn.layers.{j}"
                for nm in ("w_q", "w_k", "w_v", "out_linear"):
                    lin(f"{dst}.attn.{nm}", src["attn"][nm])
                for nm in ("fc1", "fc2"):
                    lin(f"{dst}.{nm}", src[nm])
                norm(f"{dst}.norm1", src["norm1"])
                norm(f"{dst}.norm2", src["norm2"])
            continue
        norm(f"{p}.norm1", blk["norm1"])
        norm(f"{p}.norm2", blk["norm2"])
        for nm in ("w_q", "w_k", "w_v"):
            if nm in blk:  # pct projects with w_q alone
                sd[f"{p}.{nm}.weight"] = _t(blk[nm]["kernel"]).t().contiguous()
        for nm in ("out_linear", "lin", "lin_src", "lin_dst", "pos_nn", "attn_nn"):
            if nm in attn:  # pct: lin..attn_nn, no out_linear
                lin(f"{p}.attn.{nm}", attn[nm])
        lin(f"{p}.ff.fc1", blk["ff"]["TorchLinear_0"])
        lin(f"{p}.ff.fc2", blk["ff"]["TorchLinear_1"])
        if const_layers:  # e2lsh_alpha (hept), the baselines' frozen matrices
            for nm, val in const_layers[i]["attn"].items():
                sd[f"{p}.attn.{nm}"] = _t(val)
    for nm in ("regions", "static_alpha"):
        if nm in consts:
            sd[nm] = _t(consts[nm])
    return sd


# the GNNStack's per-layer flax names -> its torch ModuleLists
_GNN_LAYER_NAMES = {"pre_ln": "pre_ln", "pre_ff": "pre_ff", "conv": "convs", "norm2": "norm2",
                    "ff0": "ff0", "ff1": "ff1"}


def _gnn_state_dict(params) -> dict[str, torch.Tensor]:
    """A GNNStack's params: TorchLinear and LayerNorm nodes by their keys,
    the raw conv parameters (`bias`, `edge_weight_w`) as they are."""
    sd: dict[str, torch.Tensor] = {}

    def node(prefix, val):
        if not hasattr(val, "keys"):
            sd[prefix] = _t(val)
        elif "kernel" in val:
            sd[f"{prefix}.weight"] = _t(val["kernel"]).t().contiguous()
            if "bias" in val:
                sd[f"{prefix}.bias"] = _t(val["bias"])
        elif "scale" in val:
            sd[f"{prefix}.weight"] = _t(val["scale"])
            sd[f"{prefix}.bias"] = _t(val["bias"])
        elif "embedding" in val:
            sd[f"{prefix}.weight"] = _t(val["embedding"])
        else:
            for k in val.keys():
                node(f"{prefix}.{k}", val[k])

    for key in params.keys():
        head, _, idx = key.rpartition("_")
        if head in _GNN_LAYER_NAMES and idx.isdigit():
            node(f"{_GNN_LAYER_NAMES[head]}.{idx}", params[key])
        elif key == "mlp_out":
            mlp = params[key]
            n_lin = sum(1 for k in mlp.keys() if k.startswith("TorchLinear_"))
            for i in range(n_lin):
                node(f"mlp_out.lins.{i}", mlp[f"TorchLinear_{i}"])
            for i in range(n_lin - 1):
                node(f"mlp_out.norms.{i}", mlp[f"LayerNorm_{i}"])
        else:
            node(key, params[key])
    return sd


# the reference's example-variant Transformer state_dict names -> the port's
# (`hept_tpu/utils/convert.py:convert_reference_hept` maps the same layout)
_REFERENCE_NAMES = (
    (r"feat_encoder\.0\.", "feat_enc_0."),
    (r"feat_encoder\.2\.", "feat_enc_1."),
    (r"attns\.(\d+)\.ff\.0\.", r"blocks.\1.ff.fc1."),
    (r"attns\.(\d+)\.ff\.2\.", r"blocks.\1.ff.fc2."),
    (r"attns\.(\d+)\.w_rpe\.weight$", r"blocks.\1.w_rpe"),
    (r"attns\.(\d+)\.attn\.e2lsh\.alpha$", r"blocks.\1.attn.e2lsh_alpha"),
    (r"attns\.(\d+)\.", r"blocks.\1."),
)


def convert_reference_hept(state_dict: Mapping, n_layers: int = 4) -> dict[str, torch.Tensor]:
    """The reference's HEPT Transformer state_dict (its example variant, as
    the shipped `example/ckpt/tracking-60k-model.pt`) as a state dict of the
    port's dynamic-key `HeptTransformer`: almost the identity, both sides
    keep torch's (out, in) Linear layout and the raw `w_rpe` weight; only
    names move (`feat_encoder.0` -> `feat_enc_0`, `attns.i` -> `blocks.i`,
    `ff.0` / `ff.2` -> `ff.fc1` / `ff.fc2`, `w_rpe.weight` -> `w_rpe`,
    `attn.e2lsh.alpha` -> `attn.e2lsh_alpha`). Layers from `n_layers` on are
    dropped, as JAX's converter reads layers 0..n_layers-1 only."""
    out: dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        layer = re.match(r"attns\.(\d+)\.", name)
        if layer and int(layer.group(1)) >= n_layers:
            continue
        for pat, rep in _REFERENCE_NAMES:
            new, hits = re.subn(pat, rep, name)
            if hits:
                name = new
                break
        out[name] = value.detach().clone() if torch.is_tensor(value) \
            else torch.as_tensor(np.asarray(value))
    return out


def load_reference_checkpoint(path: str, n_layers: int = 4) -> dict[str, torch.Tensor]:
    """`convert_reference_hept` of a reference `.pt` checkpoint (a state
    dict, or a dict holding one under "state_dict")."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_reference_hept(sd, n_layers=n_layers)
