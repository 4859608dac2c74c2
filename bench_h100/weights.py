"""Initial weights and frozen constants from the seed, made on the device.

Two draws in all, from one `torch.Generator` on the device: one uniform
vector for every Linear leaf (torch's init law, U(+-1/sqrt(fan_in))) and the
AND-region counts, one normal vector for the E2LSH directions. LayerNorms
start at (1, 0). The names and shapes are the reference's `param_spec`,
which are the port's state_dict names; the same dict goes to the port
(`load_state_dict`, strict) and to the reference.
"""

from __future__ import annotations

import math

import torch


def region_counts(u: torch.Tensor, num_regions: int, nh: int, h: int) -> torch.Tensor:
    """AND-region counts per (OR hash, head) from uniforms u (h * nh, 2):
    uniform in [lb, ub], rescaled so that their product is num_regions,
    rounded to thirds; returned (nh, 2, h) (HEPT's region draw)."""
    lb = 2.0
    ub = 2.0 * num_regions ** 0.5 - lb
    flat = u * (ub - lb) + lb
    scale = (num_regions / torch.prod(flat, dim=1, keepdim=True)) ** 0.5
    flat = torch.round(scale * flat * 3.0) / 3.0
    return flat.reshape(h, nh, 2).permute(1, 2, 0).contiguous()


def make_weights(spec: list, cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(math.prod(s) for _, s, init in spec if init[0] in ("uniform", "regions"))
    n_norm = sum(math.prod(s) for _, s, init in spec if init[0] == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device)
    nrm = torch.randn(n_norm, generator=gen, device=device)
    m = cfg["model_kwargs"]
    out, iu, inn = {}, 0, 0
    for name, shape, init in spec:
        size = math.prod(shape)
        if init[0] == "uniform":
            out[name] = (uni[iu:iu + size] * 2.0 - 1.0).mul_(init[1]).reshape(shape)
            iu += size
        elif init[0] == "regions":
            u = uni[iu:iu + size].reshape(shape[2] * shape[0], 2)
            out[name] = region_counts(u, m["num_regions"], shape[0], shape[2])
            iu += size
        elif init[0] == "normal":
            out[name] = nrm[inn:inn + size].reshape(shape).clone()
            inn += size
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
