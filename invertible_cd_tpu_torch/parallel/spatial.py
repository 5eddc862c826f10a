"""Spatial partitioning over the mesh's sp axis: each latent's height split over ranks.

The port's counterpart of what GSPMD does for JAX under `latent_sharding`
(`invertible_cd_tpu/parallel/mesh.py:84-91`): with an sp mesh each rank holds
contiguous rows of every feature map of the UNet and the VAE, and the layers
that need rows they do not hold take them from the sp group by hand:

  * a 3x3 convolution (padding 1) and the Upsample's conv: one halo row from
    each neighbour, zeros beyond the first and last rank (`halo`);
  * the Downsample's stride-2 VALID conv after its (0, 1, 0, 1) pad: one row
    from the rank below, zeros below the last rank;
  * GroupNorm: its fp32 sums of x and x^2 reduced over the group
    (`group_moments`), the statistics of the whole height;
  * self-attention: q stays on the rank's rows (Sq = S / sp), K and V are
    gathered over the group in rank order (Sk = S; a rank's rows are one
    contiguous run of the row-major tokens);
  * an int8 convolution's per-tensor activation amax: a MAX over the group.

1x1 convolutions, linear layers, LayerNorm, cross-attention (the context is
whole on every rank) and the time embedding are local. `spatial(mesh)` turns
this on for the UNet and VAE calls inside it; outside one (or with sp = 1)
every layer runs its one-process code, with no collective and no copy.

Transport: the group's collectives (`mesh.all_gather_cat`, `mesh.all_reduce`).
On NCCL they move device memory; on gloo a CUDA tensor goes through the
host.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from .mesh import Mesh, all_gather_cat, all_reduce

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("icd_torch_spatial", default=None)


@contextlib.contextmanager
def spatial(mesh: Optional[Mesh]):
    """Run the UNet and VAE calls inside on this rank's rows of `mesh`'s sp
    group (nothing changes for None or sp = 1)."""
    if mesh is None or mesh.sp == 1:
        yield
        return
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Mesh]:
    """The sp mesh of the enclosing `spatial`, or None."""
    return _ACTIVE.get()


def check_height(height: int, sp: int, levels: int, what: str = "latent") -> None:
    """Raise unless `height` splits into sp blocks of rows that halve
    `levels` - 1 times (every downsampling level keeps an even row count)."""
    unit = 2 ** (levels - 1)
    if height % (sp * unit):
        fits = [s for s in range(1, height // unit + 1) if height % (s * unit) == 0]
        raise ValueError(
            f"{what} height {height} does not split over sp={sp}: each rank's rows must "
            f"halve {levels - 1} times (a multiple of {unit}); sp values that fit: {fits}")


def halo(x: torch.Tensor, mesh: Mesh, above: int = 1, below: int = 1) -> torch.Tensor:
    """(B, C, h, W) rows of this rank -> (B, C, above + h + below, W): the
    last `above` rows of the rank above and the first `below` rows of the
    rank below, zeros beyond the first and last rank of the sp group."""
    n, i = mesh.sp, mesh.coordinate("sp")
    h = x.shape[2]
    edges = torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2)  # what the neighbours take
    every = all_gather_cat(edges.unsqueeze(0), 0, mesh, "sp")  # (sp, B, C, below + above, W)
    parts = []
    if above:
        parts.append(every[i - 1, :, :, below:] if i > 0 else x.new_zeros(x.shape[:2] + (above, x.shape[3])))
    parts.append(x)
    if below:
        parts.append(every[i + 1, :, :, :below] if i < n - 1
                     else x.new_zeros(x.shape[:2] + (below, x.shape[3])))
    return torch.cat(parts, dim=2)


def group_moments(grouped: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm's fp32 mean and E[x^2] - E[x]^2 variance (clamped at 0) of
    (B, G, n) rows over the whole height: the sums of x and x^2 reduced
    over the sp group (every rank holds as many rows)."""
    sums = all_reduce(torch.stack([grouped.sum(-1), grouped.square().sum(-1)]), mesh, "sp")
    count = grouped.shape[-1] * mesh.sp
    mean, mean_sq = sums[0] / count, sums[1] / count
    return mean, (mean_sq - mean.square()).clamp_min(0.0)
