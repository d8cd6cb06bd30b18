"""Multiresolution hash / tiled grid encoding, instant-ngp style (port of
lzzx_nerf_tpu/ops/grid.py; the reference's gridencoder CUDA extension).

Same math as the JAX package:

- per-level scale   = 2^(level*log2(per_level_scale)) * base_res - 1
  and resolution    = ceil(scale) + 1
- corner position   = floor(x*scale + 0.5) (+ corner bit)  (align_corners=False)
- index: dense row-major while the level table fits, else the XOR-prime
  hash {1, 2654435761, 805459861}, then `index % hashmap_size`
- 2^D-corner linear interpolation
- out-of-[0,1] inputs produce zeros
- per-level tables padded to a multiple of 8 rows

Plain PyTorch: one gather per level for all 2^D corners, summed corner by
corner in the JAX package's order. The uint32 index arithmetic runs on
int64 holding uint32 values, masked to 32 bits after every product and
sum (PyTorch has no wrapping uint32 multiply). The positions are computed
with the JAX package's operation order and no fused multiply-add, so a
point picks the same corner. The backward pass is autograd's transpose of
the gather (index_add); on a GPU its float sums are atomic, so their order
varies from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils.clip import clip

# XOR-prime hash constants (instant-ngp); index d multiplies primes[d]
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class GridSpec:
    """Static metadata for one multiresolution grid encoder."""

    input_dim: int
    num_levels: int
    level_dim: int
    per_level_scale: float
    base_resolution: int
    log2_hashmap_size: int
    gridtype: str = "hash"          # "hash" | "tiled"
    align_corners: bool = False
    # derived (filled by make_grid_spec)
    offsets: Tuple[int, ...] = ()            # [L+1] row offsets into the table
    resolutions: Tuple[int, ...] = ()        # [L]
    scales: Tuple[float, ...] = ()           # [L]
    use_hash: Tuple[bool, ...] = ()          # [L] hash path vs dense path
    dense_dims: Tuple[int, ...] = ()         # [L] dims the dense index covers

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def total_params(self) -> int:
        return self.offsets[-1]

    def hashmap_size(self, level: int) -> int:
        return self.offsets[level + 1] - self.offsets[level]


def make_grid_spec(
    input_dim: int = 3,
    num_levels: int = 16,
    level_dim: int = 2,
    per_level_scale: float = 2.0,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: float | None = None,
    gridtype: str = "hash",
    align_corners: bool = False,
) -> GridSpec:
    """The table sizing of the reference's gridencoder/grid.py:92-125."""
    if desired_resolution is not None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution)
                    / (num_levels - 1)))
    max_params = 2 ** log2_hashmap_size

    offsets = [0]
    resolutions, scales, use_hash, dense_dims = [], [], [], []
    for lvl in range(num_levels):
        scale = float(np.exp2(lvl * np.log2(per_level_scale))
                      * base_resolution - 1.0)
        resolution = int(np.ceil(scale)) + 1
        side = resolution if align_corners else resolution + 1
        params_in_level = min(max_params, side ** input_dim)
        params_in_level = int(np.ceil(params_in_level / 8) * 8)  # pad to 8
        offsets.append(offsets[-1] + params_in_level)
        resolutions.append(resolution)
        scales.append(scale)
        # the dense index covers dims while the running stride fits the
        # table; the hash replaces it when the whole table would not fit
        stride = 1
        nd = 0
        for _ in range(input_dim):
            if stride > params_in_level:
                break
            nd += 1
            stride *= side
        use_hash.append(gridtype == "hash" and stride > params_in_level)
        dense_dims.append(nd)

    return GridSpec(
        input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
        per_level_scale=float(per_level_scale),
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size, gridtype=gridtype,
        align_corners=align_corners, offsets=tuple(offsets),
        resolutions=tuple(resolutions), scales=tuple(scales),
        use_hash=tuple(use_hash), dense_dims=tuple(dense_dims))


def init_grid_embeddings(spec: GridSpec, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """Uniform ±1e-4 table [total_params, level_dim] (the reference's
    gridencoder/grid.py:132-134)."""
    u = torch.rand((spec.total_params, spec.level_dim), generator=generator,
                   device=device)
    return (u * 2.0 - 1.0) * 1e-4


def _level_indices(spec: GridSpec, level: int,
                   corner_pos: torch.Tensor) -> torch.Tensor:
    """Flat table row of each corner at one level: corner_pos [..., D]
    int64 holding uint32 values -> [...] int64 rows."""
    hashmap_size = spec.hashmap_size(level)
    side = spec.resolutions[level] + (0 if spec.align_corners else 1)
    index = torch.zeros_like(corner_pos[..., 0])
    if spec.use_hash[level]:
        for d in range(spec.input_dim):
            index = index ^ ((corner_pos[..., d] * _PRIMES[d]) & _M32)
    else:
        stride = 1
        for d in range(spec.dense_dims[level]):
            index = (index + ((corner_pos[..., d] * (stride & _M32))
                              & _M32)) & _M32
            stride *= side
    return index % hashmap_size + spec.offsets[level]


def _corner_bits(D: int, device) -> torch.Tensor:
    """[2^D, D] int64: bit d of corner c."""
    c = torch.arange(1 << D, device=device)
    return torch.stack([(c >> d) & 1 for d in range(D)], dim=-1)


def grid_encode(x: torch.Tensor, embeddings: torch.Tensor, spec: GridSpec,
                bound: float = 1.0) -> torch.Tensor:
    """Encode positions x [..., D] in [-bound, bound] through the table
    embeddings [total_params, level_dim] (all levels in one array) ->
    [..., num_levels * level_dim] features, level-major in the last axis
    (the reference's [B, L*C] layout). Differentiable in the table and in
    x (through the interpolation weights; floor has no gradient)."""
    D = spec.input_dim
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, D).to(torch.float32)
    u = (xf + bound) / (2.0 * bound)                    # [B, D] in [0, 1]
    in_bounds = torch.all((u >= 0.0) & (u <= 1.0), dim=-1)
    # clipped so masked-out points gather in range (jnp.clip's gradient)
    uc = clip(u, 0.0, 1.0)
    shift = 0.0 if spec.align_corners else 0.5
    bits = _corner_bits(D, x.device)                    # [2^D, D]
    n_corners = 1 << D

    feats = []
    for lvl in range(spec.num_levels):
        # float32 scale, as JAX's weak-typed Python float enters
        pos = uc * np.float32(spec.scales[lvl])
        if shift:
            pos = pos + shift
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid                           # [B, D]
        base = pos_grid.detach().to(torch.int64)
        corner_pos = base[:, None, :] + bits            # [B, 2^D, D]
        rows = _level_indices(spec, lvl, corner_pos)    # [B, 2^D]
        vals = embeddings.index_select(0, rows.reshape(-1)).reshape(
            -1, n_corners, spec.level_dim)
        # corner weights: the product over d of frac or 1 - frac, in order
        sel = torch.where(bits.bool(), frac[:, None, :],
                          1.0 - frac[:, None, :])       # [B, 2^D, D]
        w = sel[..., 0]
        for d in range(1, D):
            w = w * sel[..., d]
        contrib = w[..., None] * vals                   # [B, 2^D, C]
        acc = contrib[:, 0]
        for c in range(1, n_corners):
            acc = acc + contrib[:, c]
        feats.append(acc)
    out = torch.cat(feats, dim=-1)
    out = torch.where(in_bounds[:, None], out, out.new_zeros(()))
    return out.reshape(*batch_shape, spec.output_dim)
