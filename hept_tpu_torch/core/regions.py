"""AND-construction region machinery (port of `hept_tpu/core/regions.py`).

Each (OR-hash, head) pair draws region counts for eta and phi; points are
ranked along each coordinate and rank // region_size gives an integer region
index, later packed into one AND code per point: bit-packed integers in the
replicate padding mode (`core/buckets.py:bit_shift`), a mixed-radix float in
the zero mode (`geo_code`).
"""

from __future__ import annotations

import torch

from .buckets import invert_permutation


def get_regions(generator: torch.Generator, num_regions: int, n_hashes: int,
                num_heads: int, num_and_hashes: int = 2,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Random per-(hash, head) region counts, uniform in [lb, ub], rescaled
    so their product is `num_regions` and rounded to thirds.

    Returns: (n_hashes, num_and_hashes, num_heads) float32. The draws differ
    from `jax.random`'s; weights carried across from JAX copy this constant.
    """
    lb = 2.0
    ub = 2.0 * num_regions ** (1.0 / num_and_hashes) - lb
    flat = torch.rand((num_heads * n_hashes, num_and_hashes), generator=generator,
                      device=device) * (ub - lb) + lb
    scale = (num_regions / torch.prod(flat, dim=1, keepdim=True)) ** (1.0 / num_and_hashes)
    flat = torch.round(scale * flat * 3.0) / 3.0
    return flat.reshape(num_heads, n_hashes, num_and_hashes).permute(1, 2, 0).contiguous()


def quantile_partition(sorted_indices: torch.Tensor, num_regions: torch.Tensor,
                       n_points=None) -> torch.Tensor:
    """Region id per point by coordinate rank: `rank // ceil(n / R) + 1`.

    Args:
      sorted_indices: (n,) argsort of one coordinate.
      num_regions: (R, 1) float region counts.
      n_points: point count for the region size (default: the array length).
    Returns: (R, n) float32 region ids.
    """
    total = sorted_indices.shape[-1] if n_points is None else n_points
    # a true division, as JAX's: torch computes `int / tensor` as the
    # reciprocal times the int, which can land above an exact quotient
    # (200 / 3.3333333 -> 60.000004) and round the region size up
    total = torch.as_tensor(total, dtype=torch.float32, device=num_regions.device)
    region_size = torch.ceil(total / num_regions)
    ranks = invert_permutation(sorted_indices).to(torch.float32)
    return torch.floor(ranks[None, :] / region_size) + 1.0


def region_codes(coords: torch.Tensor, regions: torch.Tensor,
                 valid_mask: torch.Tensor | None = None, n_points=None):
    """Per-(hash*head) eta/phi region indices for one event.

    Invalid (pad) points take the largest float so they rank last; the
    argsorts are stable, as `jnp.argsort` is.
    Returns (region_eta, region_phi), each (n_hashes * num_heads, n).
    """
    eta, phi = coords[:, 0], coords[:, 1]
    if valid_mask is not None:
        big = torch.finfo(coords.dtype).max
        eta = torch.where(valid_mask, eta, big)
        phi = torch.where(valid_mask, phi, big)
    sorted_eta = torch.argsort(eta, stable=True)
    sorted_phi = torch.argsort(phi, stable=True)
    c, _, h = regions.shape
    regions_h = regions.permute(1, 0, 2).reshape(2, c * h)
    return (quantile_partition(sorted_eta, regions_h[0][:, None], n_points),
            quantile_partition(sorted_phi, regions_h[1][:, None], n_points))


def geo_code(region_eta: torch.Tensor, region_phi: torch.Tensor,
             regions: torch.Tensor) -> torch.Tensor:
    """One scalar AND code per point from its eta / phi region indices (the
    zero padding mode's codes, the reference's src variant): the mixed-radix
    `region_eta + region_phi * (ceil(eta regions) + 1)`, eta the fast axis.
    Returns (c, h, n) float32."""
    c, _, h = regions.shape
    regions_h = regions.permute(1, 0, 2).reshape(2, c * h)
    multiplier = torch.ceil(regions_h[0])[:, None] + 1.0  # (c * h, 1)
    return (region_eta + region_phi * multiplier).reshape(c, h, -1)
