"""Occupancy-grid bit utilities: Morton codes, packbits, dilation (port of
lzzx_nerf_tpu/ops/morton.py).

The occupancy grid is a natural-order [CAS, H, H, H] tensor; the Morton
encode/decode and packbits exist for checkpoint interchange and parity
tests. The bit arithmetic runs on int64 holding uint32 values (PyTorch's
uint32 support is partial), masked to 32 bits after every multiply."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = ((v * 0x00010001) & _M32) & 0xFF0000FF
    v = ((v * 0x00000101) & _M32) & 0x0F00F00F
    v = ((v * 0x00000011) & _M32) & 0xC30C30C3
    v = ((v * 0x00000005) & _M32) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] int in [0, 1024) -> [...] Morton codes (int32)."""
    c = coords.to(torch.int64) & _M32
    x = _expand_bits(c[..., 0])
    y = _expand_bits(c[..., 1])
    z = _expand_bits(c[..., 2])
    return ((x | (y << 1) | (z << 2)) & _M32).to(torch.int32)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """[...] Morton codes -> [..., 3] int32 coords."""
    i = indices.to(torch.int64) & _M32
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1),
                        _compact_bits(i >> 2)], dim=-1).to(torch.int32)


def packbits(grid: torch.Tensor, density_thresh: float) -> torch.Tensor:
    """Flat density grid -> uint8 bitfield, 8 consecutive cells per byte,
    bit i = cell (8n + i) > thresh."""
    bits = (grid.reshape(-1, 8) > density_thresh).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=grid.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_bitfield(bitfield: torch.Tensor) -> torch.Tensor:
    """uint8 bitfield [M] -> bool occupancy [M*8] (inverse of packbits)."""
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    return ((bitfield.to(torch.int32)[:, None] >> shifts) & 1).to(
        torch.bool).reshape(-1)


def dilate_grid3d(grid: torch.Tensor) -> torch.Tensor:
    """6-neighbour max dilation of a [..., H, H, H] grid: the max over each
    cell and its ±1 neighbours along each axis (a cross, not a 3x3x3
    pool). Edge cells replicate themselves for the missing neighbour, a
    no-op under max, so -1 "untrained" marks pass through as in the JAX
    package."""
    out = grid
    for axis in (-3, -2, -1):
        n = grid.shape[axis]
        fwd = torch.cat([grid.narrow(axis, 1, n - 1),
                         grid.narrow(axis, n - 1, 1)], dim=axis)
        bwd = torch.cat([grid.narrow(axis, 0, 1),
                         grid.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.maximum(out, fwd)
        out = torch.maximum(out, bwd)
    return out
