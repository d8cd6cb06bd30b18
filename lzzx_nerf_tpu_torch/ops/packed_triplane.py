"""Dense nested-octave triplane with corner-packed lookup rows (port of
lzzx_nerf_tpu/ops/packed_triplane.py: DenseTriplaneSpec, bake_packed,
packed_lookup; and encode_triplanes, the three-plane encoding of
NeRFField.encode_x).

A sample's features at every level come from ONE row of the packed table,
keyed by its cell at the packing resolution; the bilinear combine runs per
level on that row. Tables are baked in float32 and cast to the serving
dtype once, so a bf16 table holds exactly the bytes the JAX package bakes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..utils.clip import clip


@dataclass(frozen=True)
class DenseTriplaneSpec:
    resolutions: Tuple[int, ...] = (64, 128, 256, 512)
    channels: Tuple[int, ...] = (4, 3, 3, 2)
    pack_shift: int = 1

    def __post_init__(self):
        R = self.resolutions[-1]
        if tuple(sorted(self.resolutions)) != tuple(self.resolutions):
            raise ValueError("resolutions must be ascending")
        for r in self.resolutions:
            if R % r or (R // r) & (R // r - 1):
                raise ValueError("resolutions must nest by powers of two")
        if self.pack_shift < 0 or self.pack_res < 1:
            raise ValueError(f"pack_shift {self.pack_shift} leaves no "
                             "packing resolution")

    @property
    def output_dim(self) -> int:
        return sum(self.channels)

    @property
    def fine_res(self) -> int:
        return self.resolutions[-1]

    @property
    def pack_res(self) -> int:
        return self.fine_res >> self.pack_shift

    def level_points(self, r: int) -> int:
        """Grid points stored per row for a level of resolution r."""
        if r <= self.pack_res:
            return 4
        return (r // self.pack_res + 1) ** 2

    @property
    def packed_dim(self) -> int:
        return sum(self.level_points(r) * c
                   for r, c in zip(self.resolutions, self.channels))


@functools.lru_cache(maxsize=8)
def _bake_index(spec: DenseTriplaneSpec, device: str) -> torch.Tensor:
    """[pack_res² * packed_dim] int64: for each entry of the packed table,
    its index in the flat concatenation of the levels (each [r+1, r+1, C]
    in row-major order). Row (px, py), per level in order:
    - r <= pack_res (s = pack_res / r): the corners (0,0), (1,0), (0,1),
      (1,1) of cell (px // s, py // s);
    - r > pack_res (ratio = r / pack_res): the points (ratio*px + i,
      ratio*py + j), i-major."""
    P = spec.pack_res
    px, py = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    cols, base = [], 0
    for r, C in zip(spec.resolutions, spec.channels):
        def at(i, j):
            return base + (i[..., None] * (r + 1) + j[..., None]) * C + \
                np.arange(C)
        if r <= P:
            s = P // r
            cols += [at(px // s + dx, py // s + dy)
                     for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1))]
        else:
            ratio = r // P
            cols += [at(ratio * px + i, ratio * py + j)
                     for i in range(ratio + 1) for j in range(ratio + 1)]
        base += (r + 1) ** 2 * C
    idx = np.concatenate(cols, axis=-1).reshape(-1)
    return torch.from_numpy(idx).to(device)


def bake_packed(levels: Sequence[torch.Tensor], spec: DenseTriplaneSpec,
                dtype=torch.float32) -> torch.Tensor:
    """Per-level [r+1, r+1, C] grids -> packed table
    [pack_res², packed_dim] (layout: see the JAX bake_packed, and
    _bake_index): one gather from the concatenated levels, so autograd
    carries the table's gradient back to the levels as one scatter-add
    (the training step bakes in its graph). Baked in float32, cast once."""
    flat = torch.cat([A.to(torch.float32).reshape(-1) for A in levels])
    idx = _bake_index(spec, str(flat.device))
    out = flat.index_select(0, idx).reshape(spec.pack_res ** 2,
                                            spec.packed_dim)
    return out.to(dtype).contiguous()


def _block_widths(spec: DenseTriplaneSpec) -> Tuple[int, ...]:
    """Column widths of a packed row's blocks, in order: four corner
    blocks of C per level at or below the packing resolution, one window
    block of (ratio+1)² C per finer level."""
    widths = []
    for r, C in zip(spec.resolutions, spec.channels):
        widths += [C] * 4 if r <= spec.pack_res else [spec.level_points(r)
                                                       * C]
    return tuple(widths)


def packed_lookup(packed: torch.Tensor, xy01: torch.Tensor,
                  spec: DenseTriplaneSpec) -> torch.Tensor:
    """Bilinear multiresolution features via one gathered row per point.

    packed [pack_res², packed_dim] (f32 or bf16), xy01 [B, 2] in [0, 1]
    (points outside give zeros) -> [B, output_dim] f32. The combine runs in
    f32 (a bf16 table is upcast right after the gather)."""
    P = spec.pack_res
    in_bounds = ((xy01 >= 0.0) & (xy01 <= 1.0)).all(dim=-1)
    # jnp.clip's half gradient at 0 and 1 (the torso's clipped coords land
    # there)
    u = clip(xy01, 0.0, 1.0)
    pc = torch.clamp(torch.floor(u * P), 0, P - 1).to(torch.int64)
    rows = packed.index_select(0, pc[:, 0] * P + pc[:, 1]).to(torch.float32)

    # one split into the row's blocks: its backward is one concatenation,
    # where a slice per block would build and add a full-width gradient
    blocks = iter(rows.split(_block_widths(spec), dim=1))
    outs = []
    for r, C in zip(spec.resolutions, spec.channels):
        cell = torch.clamp(torch.floor(u * r), 0, r - 1).to(torch.int64)
        frac = u * r - cell.to(torch.float32)
        fx, fy = frac[:, :1], frac[:, 1:]
        if r <= P:
            c00, c10, c01, c11 = (next(blocks) for _ in range(4))
        else:
            ratio = r // P
            n = ratio + 1
            pts = next(blocks).reshape(-1, n * n, C)
            px = cell[:, 0] - pc[:, 0] * ratio                 # [B]
            py = cell[:, 1] - pc[:, 1] * ratio

            def sel(dx, dy):
                k = ((px + dx) * n + (py + dy))[:, None, None]
                return torch.take_along_dim(pts, k.expand(-1, 1, C),
                                            dim=1)[:, 0]

            c00, c10, c01, c11 = sel(0, 0), sel(1, 0), sel(0, 1), sel(1, 1)
        outs.append(c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
                    + c01 * (1 - fx) * fy + c11 * fx * fy)
    out = torch.cat(outs, dim=-1)
    return torch.where(in_bounds[:, None], out, torch.zeros_like(out))


def dense_triplane_encode(packed: torch.Tensor, xy: torch.Tensor,
                          spec: DenseTriplaneSpec,
                          bound: float = 1.0) -> torch.Tensor:
    """Map [-bound, bound] -> [0, 1] and look up a prebaked table."""
    u = (xy + bound) / (2.0 * bound)
    return packed_lookup(packed, u, spec)


def encode_triplanes(pts: torch.Tensor, tables: Dict[str, torch.Tensor],
                     spec: DenseTriplaneSpec, bound: float) -> torch.Tensor:
    """pts [N, 3] in [-bound, bound] -> [N, 36] features of the three
    planes' tables {"xy", "yz", "xz"}, planes in that order."""
    planes = (("xy", pts[:, :2]), ("yz", pts[:, 1:]),
              ("xz", torch.cat([pts[:, :1], pts[:, 2:]], dim=-1)))
    return torch.cat([dense_triplane_encode(tables[p], q, spec, bound)
                      for p, q in planes], dim=-1)
