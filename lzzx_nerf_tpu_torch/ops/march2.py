"""Interval-guided, ray-compacted marching (port of
lzzx_nerf_tpu/ops/march2.py): the serving marches and their host
planners, and the training step's window march.

Occupancy tables are built once per model load (build_inference_tables,
then ensure_variant_tables for the ones the resolved plan marches with);
per frame the renderer intersects 2x2-pixel blocks with the column z-slabs
(ray_windows), drops blocks the dilated-occupancy prepass proves dead
(prepass_block_hits), compacts the rest into a fixed budget (compact_rays)
and marches them:
- group 2, the block-shared exact march (march_rays_window_bitmask_nb_block):
  one row of the z-word-indexed 5x5 table per (2x2 block, 2-candidate
  group) serves the block's 8 candidates. The JAX package's variants of
  it (BLOCK_VARIANTS) are other tables and selects of the same samples,
  so every one marches here through nb5w's select (a session on the card
  runs it as nb5wp, the kernel of ops/march_select.py); the plan still
  steps the quadrant variants down where their envelope fails, as JAX's
  does;
- group 3, the block-lattice 3x3 march (march_rays_window_bitmask_nb_block3),
  which moves every ray of a block onto the block's lattice;
- group 1 and the per-ray compact render, the per-ray exact 3x3 march
  (march_rays_window_bitmask_nb);
- a negative group, the dilated single-column march
  (march_rays_window_bitmask) with group |march_group|.
The host planners size the candidate count K2 and step a plan down outside
its drift envelope (resolve_march_plan: group 3 -> 2, quad* -> nb5w,
2 -> 1), plan the short/long bucket march (measure_bucket_plan,
bucket_short_budget) and count the blocks the eval re-compaction keeps
(measure_real_blocks_host). The training step marches its compacted rays
with march_rays_window (the per-candidate occupancy test over each ray's
window).

Bit tables are stored as int32 tensors holding the uint32 bit patterns of
the JAX package's tables (PyTorch's uint32 support is partial); a right
shift then a mask reads the same bit either way.

This path assumes cascade == 1 (bound <= 1), like the JAX fast path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from .march import (MarchResult, _lattice_samples, first_s_select,
                    occ_lookup)
from .march_select import march_select, march_select_reference


class RayWindow(NamedTuple):
    t_start: torch.Tensor   # [N]
    t_end: torch.Tensor     # [N]
    active: torch.Tensor    # [N] bool


class InferenceTables(NamedTuple):
    """Occupancy products of the serving marches: the column intervals
    always, and the bit tables a plan needs (needed_variant_tables)."""

    z_lo: torch.Tensor                            # [H, H] window lower bound
    z_hi: torch.Tensor                            # [H, H] upper bound
    col_nb5wmask: Optional[torch.Tensor] = None   # [H*H*(H//32), 50] "nb5w"
    col_dilwords: Optional[torch.Tensor] = None   # [H*H*(H//32)] "dil"
    col_nbmask: Optional[torch.Tensor] = None     # [H*H, 9*(H//32)] "nb"
    col_bitmask: Optional[torch.Tensor] = None    # [H*H, H//32] "bit"


class CompactSet(NamedTuple):
    ray_idx: torch.Tensor     # [B] source index per slot (0 for empty slots)
    slot_valid: torch.Tensor  # [B] bool
    n_active: torch.Tensor    # scalar int (may exceed B)


def column_intervals(occ: torch.Tensor, bound: float, dilate: int = 2
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """occ [CAS, H, H, H] -> per-(x,y) column world-z bounds (z_lo, z_hi)
    [H, H]; empty columns get (+big, -big)."""
    H = occ.shape[1]
    o = occ[0].to(torch.bool)
    zs = torch.arange(H, device=occ.device, dtype=torch.float32)
    zmin = torch.where(o, zs, float(H)).amin(dim=-1)
    zmax = torch.where(o, zs, -1.0).amax(dim=-1)
    for _ in range(dilate):
        # the pools pad with -inf, which leaves every in-grid value as the
        # JAX reduce_window's (H / -1)-initialised window does
        zmin = -F.max_pool2d(-zmin[None, None], 3, 1, 1)[0, 0]
        zmax = F.max_pool2d(zmax[None, None], 3, 1, 1)[0, 0]
    z_lo = (zmin / H * 2.0 - 1.0) * bound
    z_hi = ((zmax + 1.0) / H * 2.0 - 1.0) * bound
    empty = zmax < 0
    big = torch.full_like(z_lo, 1.0e30)
    return torch.where(empty, big, z_lo), torch.where(empty, -big, z_hi)


def _cells(p: torch.Tensor, bound: float, H: int) -> torch.Tensor:
    """World positions -> int64 grid cells: clip the position, then
    clip(0.5 * (p / bound + 1) * H, 0, H - 1), truncated."""
    p = torch.clamp(p, -bound, bound)
    return torch.clamp(0.5 * (p / bound + 1.0) * H, 0, H - 1).to(
        torch.int64)


def ray_windows(rays_o, rays_d, nears, fars, z_lo, z_hi, bound: float,
                dt: float, min_axis_frac: float = 0.3, pad_steps: float = 2.0,
                probes: int = 6) -> RayWindow:
    """Intersect rays with the (x,y)-column z-slabs they cross (column
    lookups at `probes` points spread over the ray's crossing of the global
    occupied z-band); the window is the t-envelope of the nonempty slab
    crossings, padded, snapped onto the near-anchored dt lattice."""
    H = z_lo.shape[0]
    zmaps = torch.stack([z_lo, z_hi], dim=-1).reshape(H * H, 2)

    def col_lookup(t):
        p = torch.clamp(rays_o + t[:, None] * rays_d, -bound, bound)
        cx = torch.clamp(0.5 * (p[:, 0] / bound + 1.0) * H, 0, H - 1).to(
            torch.int64)
        cy = torch.clamp(0.5 * (p[:, 1] / bound + 1.0) * H, 0, H - 1).to(
            torch.int64)
        zz = zmaps.index_select(0, cx * H + cy)
        return zz[:, 0], zz[:, 1]

    oz = rays_o[:, 2]
    dz = rays_d[:, 2]
    safe_dz = torch.where(dz.abs() < 1e-6, torch.full_like(dz, 1e-6), dz)
    big = 1.0e30

    def probe_at(t):
        zl, zh = col_lookup(t)
        t1 = (zl - oz) / safe_dz
        t2 = (zh - oz) / safe_dz
        ta = torch.where(zl > zh, big, torch.minimum(t1, t2))
        tb = torch.where(zl > zh, -big, torch.maximum(t1, t2))
        valid = tb > ta
        return torch.where(valid, ta, big), torch.where(valid, tb, -big)

    valid_col = z_hi > z_lo
    zmin = torch.where(valid_col, z_lo, big).amin()
    zmax = torch.where(valid_col, z_hi, -big).amax()
    tz1 = (zmin - oz) / safe_dz
    tz2 = (zmax - oz) / safe_dz
    p_lo = torch.minimum(torch.maximum(torch.minimum(tz1, tz2), nears), fars)
    p_hi = torch.minimum(torch.maximum(torch.maximum(tz1, tz2), nears), fars)

    ta, tb = probe_at(p_lo)
    seg = p_hi - p_lo
    for i in range(max(probes - 1, 1)):
        frac = (i + 1.0) / max(probes - 1, 1)
        ta_i, tb_i = probe_at(p_lo + frac * seg)
        ta = torch.minimum(ta, ta_i)
        tb = torch.maximum(tb, tb_i)
    ta = ta - pad_steps * dt
    tb = tb + pad_steps * dt

    fallback = dz.abs() < min_axis_frac
    ta = torch.where(fallback, nears, ta)
    tb = torch.where(fallback, fars, tb)

    t_start = torch.maximum(nears, ta)
    t_end = torch.minimum(fars, tb)
    active = t_end > t_start
    k0 = torch.ceil(torch.clamp(t_start - nears, min=0.0) / dt - 1e-4)
    return RayWindow(t_start=nears + k0 * dt, t_end=t_end, active=active)


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _pack_z_words(grid: torch.Tensor) -> torch.Tensor:
    """[H, H, H] occupancy (z last) -> [H, H, H//32] int32 z-bitstrings
    (bit z%32 of word z//32)."""
    H = grid.shape[-1]
    bits = (grid > 0).reshape(*grid.shape[:-1], H // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=grid.device, dtype=torch.int64)
    return _as_int32_bits(torch.sum(bits << shifts, dim=-1))


def _check_grid(occ: torch.Tensor) -> int:
    H = occ.shape[1]
    if H % 32:
        raise ValueError("grid size must be a multiple of 32")
    return H


def column_bitmasks(occ: torch.Tensor, dilate: int = 1) -> torch.Tensor:
    """occ [CAS, H, H, H] -> [H*H, H//32]: each (x, y) column's z-words,
    OR-dilated `dilate` times over its 3x3 xy-neighbourhood (the table of
    the dilated single-column march)."""
    H = _check_grid(occ)
    od = occ[0].to(torch.float32).permute(2, 0, 1)[None]     # [1, z, x, y]
    for _ in range(dilate):
        # -inf padding leaves every window holding its in-grid maximum
        od = F.max_pool2d(od, 3, 1, 1)
    return _pack_z_words(od[0].permute(1, 2, 0)).reshape(H * H, H // 32
                                                          ).contiguous()


def _neighbourhood_blocks(occ: torch.Tensor, offsets) -> torch.Tensor:
    """[H, H, len(offsets), H//32]: for each (x, y) the z-words of the
    columns (x + dx, y + dy) for (dx, dy) in offsets (out-of-grid columns
    read as 0)."""
    H = _check_grid(occ)
    words = _pack_z_words(occ[0])                           # [H, H, W32]
    pad = max(max(abs(dx), abs(dy)) for dx, dy in offsets)
    padded = F.pad(words, (0, 0, pad, pad, pad, pad))
    return torch.stack([padded[pad + dx:pad + dx + H, pad + dy:pad + dy + H]
                        for dx, dy in offsets], dim=2)


def _word_pairs(blocks: torch.Tensor) -> torch.Tensor:
    """[R, NF, W32] z-words -> [R * W32, NF * 2]: row r * W32 + w0 holds
    each column's words (w0, w0 + 1), word W32 read as 0."""
    R, NF, W32 = blocks.shape
    padded = F.pad(blocks, (0, 1))
    w = torch.stack([padded[:, :, w0:w0 + 2] for w0 in range(W32)], dim=1)
    return w.reshape(R * W32, NF * 2).contiguous()


_NB3 = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))
_NB5 = tuple((dx, dy) for dx in range(-2, 3) for dy in range(-2, 3))


def column_bitmasks_neighborhood(occ: torch.Tensor) -> torch.Tensor:
    """occ [CAS, H, H, H] -> [H*H, 9*(H//32)]: for each (x, y) cell the
    exact z-words of its 3x3 neighbourhood, in blocks of H//32 words
    ordered (dx+1)*3 + (dy+1) (out-of-grid columns read as 0)."""
    H = occ.shape[1]
    return _neighbourhood_blocks(occ, _NB3).reshape(H * H, -1).contiguous()


def column_bitmasks_neighborhood5_words(occ: torch.Tensor) -> torch.Tensor:
    """occ [CAS, H, H, H] -> [H*H*(H//32), 50]: row (x*H + y)*W32 + w0,
    field nb*2 + i = the z-word w0+i of neighbour nb = (dx+2)*5 + (dy+2)
    of column (x, y) (out-of-grid columns and word W32 read as 0)."""
    H = occ.shape[1]
    return _word_pairs(_neighbourhood_blocks(occ, _NB5).reshape(
        H * H, 25, H // 32))


def dilated_occupancy_words(occ: torch.Tensor, dxy: int = 2, dz: int = 3
                            ) -> torch.Tensor:
    """occ [CAS, H, H, H] -> [H*H*(H//32)]: the occupancy max-pooled over a
    (2*dxy+1, 2*dxy+1, 2*dz+1) window (out-of-grid reads as empty), packed
    as z-words, one word per (x, y, z-word)."""
    H = occ.shape[1]
    od = occ[0].to(torch.float32)[None, None]
    od = F.max_pool3d(od, (2 * dxy + 1, 2 * dxy + 1, 2 * dz + 1), 1,
                      (dxy, dxy, dz))[0, 0]
    return _pack_z_words(od).reshape(H * H * (H // 32)).contiguous()


# table name -> (InferenceTables field, builder)
_TABLES = {
    "nb5w": ("col_nb5wmask", column_bitmasks_neighborhood5_words),
    "dil": ("col_dilwords", dilated_occupancy_words),
    "nb": ("col_nbmask", column_bitmasks_neighborhood),
    "bit": ("col_bitmask", column_bitmasks),
}
# the group-2 block march's variants: nb5w / nb5wp and the JAX package's
# alternate tables and selects of the same samples, each marched here as
# nb5w
BLOCK_VARIANTS = ("nb5w", "nb5wp", "nb5wz", "nb5wz4", "wslice", "nb_first",
                  "zband", "zband4", "quad", "quadw", "quadwx")
QUAD_VARIANTS = ("quad", "quadw", "quadwx")


def build_inference_tables(occ: torch.Tensor, bound: float,
                           dilate_intervals: int = 2,
                           variants: Tuple[str, ...] = ("nb5w", "dil")
                           ) -> InferenceTables:
    """The column intervals and the bit tables named in `variants` (the
    keys of _TABLES); the default builds those of the nb5w/nb5wp block
    march with prepass. A session builds with variants=() and then the
    tables its resolved plan needs (needed_variant_tables)."""
    z_lo, z_hi = column_intervals(occ, bound, dilate=dilate_intervals)
    return ensure_variant_tables(InferenceTables(z_lo=z_lo, z_hi=z_hi), occ,
                                 variants)


def needed_variant_tables(march_group: int, march_variant: str,
                          prepass: bool = False) -> Tuple[str, ...]:
    """The bit tables a resolved plan marches with: the group-2 block
    march, in every variant, the nb5w table (with the prepass also the
    dilated words), groups 1 and 3 (and the per-ray compact render) the
    3x3-neighbourhood table, a negative group the dilated single-column
    table. The JAX package builds its 3x3 and single-column tables with
    every plan, and a variant's own table; here each is built when a plan
    needs it."""
    if march_group == 2:
        if march_variant not in BLOCK_VARIANTS:
            raise ValueError(
                f"unknown nb-block select variant {march_variant!r}")
        return ("nb5w",) + (("dil",) if prepass else ())
    if march_group in (1, 3):
        return ("nb",)
    if march_group < 0:
        return ("bit",)
    raise ValueError(f"march group {march_group}: 1, 2, 3 or a negative "
                     "dilated group")


def ensure_variant_tables(tables: InferenceTables, occ: torch.Tensor,
                          need: Tuple[str, ...]) -> InferenceTables:
    """Build the tables in `need` that `tables` lacks."""
    upd = {}
    for v in need:
        field, fn = _TABLES[v]
        if getattr(tables, field) is None:
            upd[field] = fn(occ)
    return tables._replace(**upd) if upd else tables


def _prepass_group_hits(o_blk, d_center, t0_blk, t1_blk, col_dilwords,
                        bound, dt, num_cand):
    """Per-(block, group) dilated-occupancy hit matrix [NB, G]: the bit at
    each group-fetch lattice point t0 + (2g+1)*dt, gated on the group
    starting before the window end (one dt of slack)."""
    H = int(round((32 * col_dilwords.shape[0]) ** (1.0 / 3.0)))
    W32 = H // 32
    if H * H * W32 != col_dilwords.shape[0]:
        raise ValueError("col_dilwords is not an [H*H*(H//32)] table")
    G = (num_cand + 1) // 2
    gk = torch.arange(G, device=o_blk.device, dtype=torch.float32) * 2 + 1.0
    t_g = t0_blk[:, None] + gk[None] * dt                      # [NB, G]
    gp = _cells(o_blk[:, None, :] + t_g[..., None] * d_center[:, None, :],
                bound, H)
    gx, gy, gz = gp[..., 0], gp[..., 1], gp[..., 2]
    words = col_dilwords[(gx * H + gy) * W32 + (gz >> 5)]
    bit = ((words >> (gz & 31)) & 1) > 0
    live = (t_g - dt) < (t1_blk[:, None] + dt)
    return bit & live


def prepass_block_hits(o_blk, d_center, t0_blk, t1_blk, col_dilwords,
                       bound: float, dt: float, num_cand: int
                       ) -> torch.Tensor:
    """Occupancy-true block activity [NB] bool: False proves the block's
    march keeps no sample for any of its 4 rays."""
    return _prepass_group_hits(o_blk, d_center, t0_blk, t1_blk,
                               col_dilwords, bound, dt, num_cand).any(dim=1)


def prepass_block_spans(o_blk, d_center, t0_blk, t1_blk, col_dilwords,
                        bound: float, dt: float, num_cand: int):
    """prepass_block_hits plus the first/last hit group per block:
    (hit [NB] bool, g_first [NB] int32, g_last [NB] int32)."""
    h = _prepass_group_hits(o_blk, d_center, t0_blk, t1_blk, col_dilwords,
                            bound, dt, num_cand)
    G = h.shape[1]
    hu = h.to(torch.uint8)
    g_first = torch.argmax(hu, dim=1).to(torch.int32)
    g_last = (G - 1 - torch.argmax(hu.flip(1), dim=1)).to(torch.int32)
    return h.any(dim=1), g_first, g_last


def compact_rays(active: torch.Tensor, budget: int) -> CompactSet:
    """First-`budget` active entries -> slot table. Overflowing entries are
    dropped (reported through n_active > budget); the drop is an explicit
    write to a discarded extra slot, the JAX scatter's mode="drop"."""
    rank = torch.cumsum(active.to(torch.int64), dim=0) - 1
    n_active = rank[-1] + 1
    N = active.shape[0]
    slot = torch.where(active, rank, torch.full_like(rank, budget))
    slot = torch.clamp(slot, max=budget)
    buf = torch.zeros(budget + 1, dtype=torch.int64, device=active.device)
    buf.scatter_(0, slot, torch.arange(N, device=active.device))
    slot_valid = torch.arange(budget, device=active.device) < torch.clamp(
        n_active, max=budget)
    return CompactSet(ray_idx=buf[:budget], slot_valid=slot_valid,
                      n_active=n_active)


def march_rays_window(rays_o, rays_d, t_start, t_end, slot_valid,
                      occ_grid, bound: float, dt: float, num_cand: int,
                      max_samples: int, noise=None, nears=None
                      ) -> MarchResult:
    """march_rays_uniform's candidate lattice, occupancy test (cascade 0)
    and first-S select over each compacted ray's window only: the training
    step's march.

    noise [B] in [0, 1): the near-anchored noisy lattice
    nears + (k + noise) * dt. The window start is snapped up to the
    unshifted lattice, so the lattice starts one step early and candidates
    below the full marcher's own start (nears + noise * dt) are masked:
    the sample set is then exactly the full marcher's within the window."""
    H = occ_grid.shape[1]
    if max_samples > num_cand:
        raise ValueError(
            f"max_samples ({max_samples}) cannot exceed window candidates "
            f"({num_cand})")
    if noise is None:
        t0 = t_start
        floor_t = None
    else:
        if nears is None:
            raise ValueError("noise marching needs `nears` for the lattice "
                             "floor")
        t0 = t_start + dt * (noise - 1.0)
        floor_t = nears + dt * noise - 1e-4 * dt
    k = torch.arange(num_cand, dtype=torch.float32, device=rays_o.device)
    t_cand = t0[:, None] + k[None, :] * dt                     # [B, K2]
    gp = _cells(rays_o[:, None, :] + t_cand[..., None] * rays_d[:, None, :],
                bound, H)
    flat = gp[..., 0] * (H * H) + gp[..., 1] * H + gp[..., 2]
    valid = (occ_lookup(occ_grid[0], flat) & (t_cand < t_end[:, None])
             & slot_valid[:, None])
    if floor_t is not None:
        valid = valid & (t_cand >= floor_t[:, None])
    sel_k, mask = first_s_select(valid, num_cand, max_samples)
    return _lattice_samples(rays_o, rays_d, t0, sel_k, mask, bound, dt)


def _anchor_cells(p: torch.Tensor, bound: float, H: int) -> torch.Tensor:
    """Fetch-point positions -> int64 cells in the JAX marchers' float
    order for anchors: clip((p / bound + 1) * 0.5 * H, 0, H - 1) of the
    clipped position (_cells multiplies by 0.5 first, as JAX does for the
    candidates)."""
    q = (torch.clamp(p, -bound, bound) / bound + 1.0) * 0.5 * H
    return torch.clamp(q, 0, H - 1).to(torch.int64)


def _noisy_lattice(t_start, dt: float, noise, nears):
    """(lattice start t0, floor below which candidates are masked or
    None): march_rays_window's training lattice."""
    if noise is None:
        return t_start, None
    if nears is None:
        raise ValueError("noise marching needs `nears` for the lattice "
                         "floor")
    return t_start + dt * (noise - 1.0), nears + dt * noise - 1e-4 * dt


def _check_samples(max_samples: int, num_cand: int) -> None:
    if max_samples > num_cand:
        raise ValueError(
            f"max_samples ({max_samples}) cannot exceed window candidates "
            f"({num_cand})")


def march_rays_window_bitmask(rays_o, rays_d, t_start, t_end, slot_valid,
                              col_bitmask: torch.Tensor, bound: float,
                              dt: float, num_cand: int, max_samples: int,
                              group: int = 2) -> MarchResult:
    """The dilated single-column march (march_group < 0 with group =
    |march_group|): one column fetch of the dilated table (column_bitmasks)
    per `group` consecutive candidates, at the group's midpoint, and each
    candidate's z bit from that column. A superset of the exact march's
    samples (empty neighbour cells the dilation admits can take a slot)."""
    B = rays_o.shape[0]
    W32 = col_bitmask.shape[1]
    H = W32 * 32
    _check_samples(max_samples, num_cand)
    G = (num_cand + group - 1) // group
    dev = rays_o.device
    k = torch.arange(num_cand, dtype=torch.float32, device=dev)
    t_cand = t_start[:, None] + k[None] * dt                   # [B, K2]
    gk = torch.arange(G, dtype=torch.float32, device=dev) * group + (
        group - 1) / 2.0
    t_g = t_start[:, None] + gk[None] * dt                     # [B, G]
    pg = _anchor_cells(rays_o[:, None, :] + t_g[..., None]
                       * rays_d[:, None, :], bound, H)
    rows = col_bitmask.index_select(0, (pg[..., 0] * H + pg[..., 1])
                                    .reshape(-1)).reshape(B, G, W32)
    pz = rays_o[:, 2:3] + t_cand * rays_d[:, 2:3]
    cz = _anchor_cells(pz, bound, H)                           # [B, K2]
    # candidate k reads the row of its group k // group
    grp = (torch.arange(num_cand, device=dev) // group)[None].expand(B, -1)
    row_k = torch.gather(rows, 1, grp[..., None].expand(B, num_cand, W32))
    wsel = torch.gather(row_k, 2, (cz >> 5)[..., None])[..., 0]
    occ = ((wsel.to(torch.int64) >> (cz & 31)) & 1) > 0
    valid = occ & (t_cand < t_end[:, None]) & slot_valid[:, None]
    sel_k, mask = first_s_select(valid, num_cand, max_samples)
    return _lattice_samples(rays_o, rays_d, t_start, sel_k, mask, bound, dt)


def march_rays_window_bitmask_nb(rays_o, rays_d, t_start, t_end, slot_valid,
                                 col_nbmask: torch.Tensor, bound: float,
                                 dt: float, num_cand: int, max_samples: int,
                                 noise=None, nears=None) -> MarchResult:
    """The per-ray exact march over the 3x3-neighbourhood table: one
    table row per 2-candidate group, fetched at the group's midpoint
    (lattice position 2g + 0.5), serves both candidates, each reading its
    own column's z-bit from the row (its xy cell lies within ±1 of the
    fetch cell while (dt/2) x cells-per-world <= 1, checked here). The
    sample set equals march_rays_window's, as in the JAX package.

    noise/nears: march_rays_window's training lattice (candidates at
    nears + (k + noise) * dt, started one step before the snapped
    t_start, pre-floor candidates masked); the fetch points ride the same
    shifted lattice."""
    B = rays_o.shape[0]
    W32 = col_nbmask.shape[1] // 9
    H = W32 * 32
    if col_nbmask.shape != (H * H, 9 * W32):
        raise ValueError("col_nbmask is not an [H*H, 9*(H//32)] table")
    t0, floor_t = _noisy_lattice(t_start, dt, noise, nears)
    drift_cells = (dt / 2.0) * H / (2.0 * bound)
    if drift_cells > 1.0 + 1e-6:
        raise ValueError(
            f"nb-march drift {drift_cells:.2f} cells exceeds the ±1 "
            f"neighborhood (dt={dt:.4f}, bound={bound}); use "
            "march_rays_window for this geometry")
    _check_samples(max_samples, num_cand)
    G = (num_cand + 1) // 2
    dev = rays_o.device
    kg = (torch.arange(G, device=dev, dtype=torch.float32)[:, None] * 2
          + torch.arange(2, device=dev, dtype=torch.float32)[None, :])
    t_cand = t0[:, None, None] + kg[None] * dt                 # [B, G, 2]
    gk = torch.arange(G, device=dev, dtype=torch.float32) * 2 + 0.5
    t_g = t0[:, None] + gk[None] * dt                          # [B, G]
    pg = _anchor_cells(rays_o[:, None, :] + t_g[..., None]
                       * rays_d[:, None, :], bound, H)
    gx, gy = pg[..., 0], pg[..., 1]
    gp = _cells(rays_o[:, None, None, :]
                + t_cand[..., None] * rays_d[:, None, None, :], bound, H)
    cx, cy, cz = gp[..., 0], gp[..., 1], gp[..., 2]            # [B, G, 2]
    nb = ((torch.clamp(cx - gx[..., None], -1, 1) + 1) * 3
          + torch.clamp(cy - gy[..., None], -1, 1) + 1)
    # the candidate's word of its own column in the fetched row
    row = (gx * H + gy)[..., None]
    words = col_nbmask.reshape(-1)[row * (9 * W32) + nb * W32 + (cz >> 5)]
    occ = ((words >> (cz & 31)) & 1) > 0
    t_cand = t_cand.reshape(B, 2 * G)[:, :num_cand]
    occ = occ.reshape(B, 2 * G)[:, :num_cand]
    valid = occ & (t_cand < t_end[:, None]) & slot_valid[:, None]
    if floor_t is not None:
        valid = valid & (t_cand >= floor_t[:, None])
    sel_k, mask = first_s_select(valid, num_cand, max_samples)
    return _lattice_samples(rays_o, rays_d, t0, sel_k, mask, bound, dt)


# a debugging check of the block-lattice march's word-pair select (the JAX
# package's DEBUG_WORD_ENVELOPE): a live candidate whose z-word lies
# outside its group's pair {w0, w0 + 1} would read the wrong word. The envelope rules
# it out for every geometry the plan admits; when this flag is on, the
# marches count such candidates (a host sync per march) so a test can
# assert none occurred. Off in production.
DEBUG_WORD_ENVELOPE = False
_word_envelope_violations = 0


def reset_word_envelope_violations() -> None:
    global _word_envelope_violations
    _word_envelope_violations = 0


def word_envelope_violations() -> int:
    return _word_envelope_violations


def _word_pair_index(word, w0b, live):
    """clip(word - w0, 0, 1), counting the candidates outside the pair
    when DEBUG_WORD_ENVELOPE is on."""
    global _word_envelope_violations
    delta = word - w0b
    if DEBUG_WORD_ENVELOPE:
        _word_envelope_violations += int((((delta < 0) | (delta > 1))
                                          & live).sum())
    return torch.clamp(delta, 0, 1)


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int32 table words -> int64 holding their uint32 values."""
    return v.to(torch.int64) & 0xFFFFFFFF


def _word_pair_rows(rows: torch.Tensor, w0: torch.Tensor) -> torch.Tensor:
    """rows [Bb, G, NF, W32], w0 [Bb, G] -> [Bb, G, NF, 2]: each column's
    words (w0, w0 + 1), a word past the column reading as 0."""
    Bb, G, NF, W32 = rows.shape
    padded = F.pad(rows, (0, 1))
    idx = (w0[..., None] + torch.arange(2, device=w0.device))[:, :, None]
    return torch.gather(padded, 3, idx.expand(Bb, G, NF, 2))


def _select_fields(rows: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """rows [Bb, G, F] (one per block and group), j [Bb, 4, G, 2] field
    indices -> the candidates' fields [Bb, 4, G, 2]."""
    Bb, G, Fw = rows.shape
    src = rows[:, None].expand(Bb, 4, G, Fw)
    return torch.gather(src, 3, j)


def march_rays_window_bitmask_nb_block(
    rays_o: torch.Tensor,      # [4*Bb, 3] block-major (4 rays per block)
    rays_d: torch.Tensor,      # [4*Bb, 3]
    t_start: torch.Tensor,     # [4*Bb] per-ray snapped window start
    t_end: torch.Tensor,       # [4*Bb]
    slot_valid: torch.Tensor,  # [4*Bb] bool
    t0_block: torch.Tensor,    # [Bb] block window start (fetch anchor)
    d_center: torch.Tensor,    # [Bb, 3] unit block-centre direction
    col_mask: torch.Tensor,    # [H*H*(H//32), 50] (nb5w table)
    bound: float,
    dt: float,
    num_cand: int,             # K2
    max_samples: int,          # S
    variant: str = "nb5wp",
) -> MarchResult:
    """Block-shared exact march over the z-word-indexed 5x5-neighbourhood
    table: one anchor per (2x2-pixel block, 2-candidate group), at the
    midpoint 2g+1 of the group's span, serves all 8 candidates.

    variant "nb5wp": the candidate select and first-S scan run as the CUDA
    kernel (ops/march_select.py) on CUDA tensors. Every other variant of
    BLOCK_VARIANTS runs the same select in plain PyTorch
    (march_select_reference) on any device, the kernel's reference. The
    JAX package's variants read other tables through other selects, and
    keep these samples bit for bit within their envelopes
    (resolve_march_plan)."""
    if variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown nb-block select variant {variant!r}")
    B = rays_o.shape[0]
    if B % 4:
        raise ValueError("block march needs 4 rays per block")
    Bb = B // 4
    H = int(round((32 * col_mask.shape[0]) ** (1.0 / 3.0)))
    W32 = H // 32
    if H * H * W32 != col_mask.shape[0] or col_mask.shape[1] != 50:
        raise ValueError("col_mask is not an nb5w [H*H*(H//32), 50] table")
    step_cells = dt * H / (2.0 * bound)
    if step_cells > 2.0 + 1e-6:
        raise ValueError(
            f"nb-block march: {step_cells:.2f} cells per lattice step "
            "exceeds the ±2 neighbourhood")
    _check_samples(max_samples, num_cand)
    G = (num_cand + 1) // 2

    ob = rays_o.reshape(Bb, 4, 3)
    o_blk = (((ob[:, 0] + ob[:, 1]) + ob[:, 2]) + ob[:, 3]) / 4.0
    gk = torch.arange(G, device=rays_o.device, dtype=torch.float32) * 2 + 1.0
    t_g = t0_block[:, None] + gk[None] * dt                    # [Bb, G]
    pg = _anchor_cells(o_blk[:, None, :] + t_g[..., None]
                       * d_center[:, None, :], bound, H)
    gx, gy, gz = pg[..., 0], pg[..., 1], pg[..., 2]
    w0 = torch.clamp(torch.clamp(gz - 3, min=0) >> 5, 0, W32 - 1)

    select = march_select if variant == "nb5wp" else march_select_reference
    sel = select(col_mask, gx.to(torch.int32), gy.to(torch.int32),
                 w0.to(torch.int32), rays_o, rays_d, t_start, t_end,
                 slot_valid, bound, dt, H, num_cand, max_samples)
    mask = sel >= 0
    sel_k = torch.where(mask, sel, 0).to(torch.float32)
    return _lattice_samples(rays_o, rays_d, t_start, sel_k, mask, bound, dt)


def march_rays_window_bitmask_nb_block3(
    rays_o: torch.Tensor,      # [4*Bb, 3] block-major
    rays_d: torch.Tensor,      # [4*Bb, 3]
    nears: torch.Tensor,       # [4*Bb] per-ray AABB entry
    t_end: torch.Tensor,       # [4*Bb]
    slot_valid: torch.Tensor,  # [4*Bb]
    t0_block: torch.Tensor,    # [Bb] the block lattice's start
    d_center: torch.Tensor,    # [Bb, 3]
    col_nbmask: torch.Tensor,  # [H*H, 9*(H//32)] (3x3 neighbourhood)
    bound: float,
    dt: float,
    num_cand: int,
    max_samples: int,
) -> MarchResult:
    """The block-lattice march (march_group 3): all 4 rays of a block march
    on the block's lattice t0_block + k*dt, so a candidate lies dt/2 from
    its group's anchor (2g + 0.5) and the 3x3 neighbourhood covers its
    drift (nb_block3_drift_cells <= 1). Candidates before a ray's own
    AABB entry are masked (nears), not lattice-shifted. Its samples sit on
    another lattice than the per-ray marches': it is not sample-equal to
    them (the JAX package's opt-in negative result)."""
    B = rays_o.shape[0]
    if B % 4:
        raise ValueError("block march needs 4 rays per block")
    Bb = B // 4
    W32 = col_nbmask.shape[1] // 9
    H = W32 * 32
    half_step_cells = (dt / 2.0) * H / (2.0 * bound)
    if half_step_cells > 1.0 + 1e-6:
        raise ValueError(
            f"nb-block3 march: {half_step_cells:.2f} cells per half-step "
            "exceeds the ±1 neighbourhood")
    _check_samples(max_samples, num_cand)
    G = (num_cand + 1) // 2
    Kp = 2 * G
    dev = rays_o.device
    ob = rays_o.reshape(Bb, 4, 3)
    o_blk = (((ob[:, 0] + ob[:, 1]) + ob[:, 2]) + ob[:, 3]) / 4.0
    gk = torch.arange(G, device=dev, dtype=torch.float32) * 2 + 0.5
    t_g = t0_block[:, None] + gk[None] * dt
    pg = _anchor_cells(o_blk[:, None, :] + t_g[..., None]
                       * d_center[:, None, :], bound, H)
    gx, gy, gz = pg[..., 0], pg[..., 1], pg[..., 2]
    rows = _u32(col_nbmask.index_select(0, (gx * H + gy).reshape(-1))
                ).reshape(Bb, G, 9, W32)
    kg = (torch.arange(G, device=dev, dtype=torch.float32)[:, None] * 2
          + torch.arange(2, device=dev, dtype=torch.float32)[None, :])
    t_cand = t0_block[:, None, None] + kg[None] * dt           # [Bb, G, 2]
    t_cand4 = t_cand[:, None].expand(Bb, 4, G, 2)
    gp = _cells(rays_o.reshape(Bb, 4, 1, 1, 3)
                + t_cand4[..., None] * rays_d.reshape(Bb, 4, 1, 1, 3),
                bound, H)
    cxb, cyb, czb = gp[..., 0], gp[..., 1], gp[..., 2]
    nb = ((torch.clamp(cxb - gx[:, None, :, None], -1, 1) + 1) * 3
          + torch.clamp(cyb - gy[:, None, :, None], -1, 1) + 1)
    live = None
    if DEBUG_WORD_ENVELOPE:
        live = ((t_cand4 < t_end.reshape(Bb, 4)[..., None, None])
                & slot_valid.reshape(Bb, 4)[..., None, None])
    w0 = torch.clamp(torch.clamp(gz - 2, min=0) >> 5, 0, W32 - 1)
    pairs = _word_pair_rows(rows, w0).reshape(Bb, G, 18)
    wsel = _select_fields(pairs, nb * 2 + _word_pair_index(
        czb >> 5, w0[:, None, :, None], live))
    occ = (((wsel >> (czb & 31)) & 1) > 0).reshape(B, Kp)[:, :num_cand]
    t_cand = t_cand4.reshape(B, Kp)[:, :num_cand]
    valid = (occ & (t_cand >= nears[:, None]) & (t_cand < t_end[:, None])
             & slot_valid[:, None])
    sel_k, mask = first_s_select(valid, num_cand, max_samples)
    t0r = t0_block[:, None].expand(Bb, 4).reshape(B)
    return _lattice_samples(rays_o, rays_d, t0r, sel_k, mask, bound, dt)


# ---- host planners (once per model load) --------------------------------

def default_window_candidates(bound: float, grid_size: int, dt: float,
                              max_extent: float = 1.2) -> int:
    """Static K2 covering `max_extent` world units of window plus pad."""
    return int(math.ceil(max_extent / dt)) + 4


def _drift_terms(dt, bound, grid_size, focal, t_max, min_dz):
    """(lattice step drift, intra-block angular drift) in cells."""
    cells_per_world = grid_size / (2.0 * bound)
    max_dxy = math.sqrt(max(0.0, 1.0 - min_dz * min_dz))
    step = dt * cells_per_world * max(max_dxy, 1e-3)
    angular = t_max * (1.0 / max(focal, 1e-6)) * cells_per_world
    return step, angular


def nb_block_drift_cells(dt: float, bound: float, grid_size: int,
                         focal: float, t_max: float, min_dz: float) -> float:
    """Worst-case per-axis cell drift between a candidate's xy cell and its
    block-shared fetch cell; the block march is exact while it is <= 2."""
    step, angular = _drift_terms(dt, bound, grid_size, focal, t_max, min_dz)
    return step + angular


def nb_blockq_drift_cells(dt: float, bound: float, grid_size: int,
                          focal: float, t_max: float, min_dz: float
                          ) -> Tuple[float, float]:
    """(forward, backward) worst-case drift of the quadrant-anchored block
    march: its half-step anchor makes the lattice drift one-sided (1.5
    steps forward, 0.5 back), plus the angular term both ways. Exact while
    forward <= 2 and backward <= 1 (the signed {-1, 0, +1, +2} window)."""
    step, angular = _drift_terms(dt, bound, grid_size, focal, t_max, min_dz)
    return 1.5 * step + angular, 0.5 * step + angular


def nb_block3_drift_cells(dt: float, bound: float, grid_size: int,
                          focal: float, t_max: float, min_dz: float) -> float:
    """Worst-case drift of the block-lattice 3x3 march: half a step (every
    candidate lies dt/2 from its anchor) plus the angular term; exact
    while <= 1."""
    step, angular = _drift_terms(dt, bound, grid_size, focal, t_max, min_dz)
    return 0.5 * step + angular


def block_view(rays_d: torch.Tensor, H: int, W: int):
    """[..., H*W, 3] row-major directions -> (d_blocks [..., NB, 4, 3],
    unit block-centre directions d_center [..., NB, 3])."""
    lead = rays_d.shape[:-2]
    db = rays_d.reshape(*lead, H // 2, 2, W // 2, 2, 3)
    n = len(lead)
    db = db.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4).reshape(
        *lead, H * W // 4, 4, 3)
    dc = db.mean(dim=-2)
    dc = dc / torch.linalg.vector_norm(dc, dim=-1, keepdim=True)
    return db, dc


def measured_window_candidates(settings, z_lo, z_hi, poses, intrinsics,
                               H: int, W: int, block: bool = True,
                               margin: int = 4, pose_batch: int = 8) -> int:
    """Exact per-trajectory K2: the serving window analysis over every
    pose, sized from the largest candidate count any active window needs,
    plus `margin`. block=True measures the 2x2-block-centre windows (pad
    3.0, as render_rays_compact_blocks runs it), block=False the per-ray
    windows (pad 2.0, render_rays_compact)."""
    from ..utils.rays import get_rays
    from .ray import near_far_from_aabb

    dev = z_lo.device
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 4, 4),
                            device=dev)
    mx = 0.0
    for s in range(0, len(poses), pose_batch):
        rays = get_rays(poses[s:s + pose_batch], intrinsics, H, W)
        if block:
            _, d = block_view(rays["rays_d"], H, W)
            o = rays["rays_o"][:, :1].expand(d.shape)
        else:
            d, o = rays["rays_d"], rays["rays_o"]
        d = d.reshape(-1, 3)
        o = o.reshape(-1, 3)
        nears, fars = near_far_from_aabb(o, d, aabb, settings.min_near)
        win = ray_windows(o, d, nears, fars, z_lo, z_hi, settings.bound,
                          settings.dt, pad_steps=3.0 if block else 2.0)
        steps = torch.ceil((win.t_end - win.t_start) / settings.dt)
        mx = max(mx, float(torch.where(win.active, steps,
                                       torch.zeros_like(steps)).max()))
    k2 = int(mx) + 1 + margin
    k2 = max(k2, settings.max_steps, 16)
    return k2 + (k2 % 2)


def window_candidates_for_scene(z_lo, z_hi, dt: float, min_dz: float = 0.8,
                                pad_steps: float = 3.0,
                                margin: int = 6) -> int:
    """Geometric K2 bound from the occupied z-band and the shallowest
    camera obliquity (host-side)."""
    zl = np.asarray(z_lo)
    zh = np.asarray(z_hi)
    valid = zh > zl
    band = (float(zh[valid].max() - zl[valid].min())
            if valid.any() else 0.0)
    k2 = (int(np.ceil(band / (dt * max(min_dz, 0.3))))
          + int(2 * pad_steps) + margin)
    k2 = max(k2, 16)
    return k2 + (k2 % 2)


def resolve_march_plan(settings, z_lo, z_hi, poses, intrinsics, H: int,
                       W: int, k2_override: int = 0, march_group: int = 1,
                       march_variant: str = "wslice",
                       measure: Optional[str] = None, log=print
                       ) -> Tuple[int, int, str]:
    """The serving march plan for one model and camera geometry ->
    (k2, march_group, march_variant). K2 is k2_override when nonzero,
    else the geometric bound (window_candidates_for_scene), tightened
    with measure="block"/"ray" to the trajectory-measured count. Then the
    plan steps down wherever this geometry leaves a march's drift
    envelope: group 3 -> 2 (nb_block3_drift_cells > 1), a quadrant
    variant -> nb5w (nb_blockq_drift_cells beyond +2 / -1), group 2 -> 1
    (nb_block_drift_cells > 2). march_group=1 skips the checks (the
    non-block callers)."""
    from ..utils.rays import min_corner_dz

    dz = min_corner_dz(poses, intrinsics, H, W)
    k2 = k2_override
    if not k2:
        k2 = window_candidates_for_scene(
            z_lo.detach().cpu().numpy(), z_hi.detach().cpu().numpy(),
            settings.dt, min_dz=dz)
        if measure in ("block", "ray"):
            k2m = measured_window_candidates(settings, z_lo, z_hi, poses,
                                             intrinsics, H, W,
                                             block=measure == "block")
            if k2m < k2:
                log(f"[INFO] trajectory-measured window candidates: "
                    f"K2={k2m} (geometric bound {k2})")
                k2 = k2m
            else:
                log(f"[INFO] adaptive window candidates: K2={k2} "
                    f"(measured {k2m} >= geometric bound)")
        else:
            log(f"[INFO] adaptive window candidates: K2={k2} "
                f"(grid {settings.grid_size}, dt {settings.dt:.4f})")
    if march_group in (2, 3):
        t_max = float(np.linalg.norm(np.asarray(poses)[:, :3, 3],
                                     axis=1).max()
                      ) + math.sqrt(3.0) * settings.bound
        geo = (settings.dt, settings.bound, settings.grid_size,
               min(intrinsics[0], intrinsics[1]), t_max, dz)
        if march_group == 3:
            drift3 = nb_block3_drift_cells(*geo)
            if drift3 > 1.0:
                log(f"[INFO] block-lattice march drift {drift3:.2f} cells "
                    "exceeds the ±1 envelope for this camera/grid — using "
                    "the ±2 block-shared march")
                march_group = 2
        if march_group == 2 and march_variant in QUAD_VARIANTS:
            fwd, back = nb_blockq_drift_cells(*geo)
            if fwd > 2.0 or back > 1.0:
                log(f"[INFO] quadrant march drift ({fwd:.2f} fwd, "
                    f"{back:.2f} back) exceeds the signed window for this "
                    "camera/grid — using the symmetric ±2 block-shared "
                    "march")
                march_variant = "nb5w"
        if march_group == 2:
            drift = nb_block_drift_cells(*geo)
            if drift > 2.0:
                log(f"[INFO] block-shared march drift {drift:.2f} cells "
                    "exceeds the ±2 envelope for this camera/grid — using "
                    "the per-ray exact neighborhood march")
                march_group = 1
    return k2, march_group, march_variant


def bucket_short_budget(n_short: int, budget: int, gran: int,
                        margin: int = 64) -> int:
    """The short-bucket budget: the measured short demand plus `margin`,
    rounded up to the slot granularity and capped so the long bucket keeps
    at least one granule. 0 when no valid carve exists (the caller then
    marches one bucket)."""
    if budget <= gran:
        return 0
    bs = min(budget - gran,
             max(gran, -(-(n_short + margin) // gran) * gran))
    return bs if 0 < bs < budget and bs % 4 == 0 else 0


def measure_real_blocks_host(occ3, aabb, min_near: float, origin,
                             d_blocks, t_start_blk, t_end_blk, active_blk,
                             bound: float, dt: float, K2: int,
                             chunk: int = 16384) -> int:
    """Host-side exact count (numpy) of the real 2x2 blocks: blocks where
    at least one of the 4 rays has a candidate in an occupied cell, which
    sizes the eval re-compaction's budget (render_rays_compact_blocks
    eval_budget). It runs the march's per-candidate test: each ray's
    near-anchored dt lattice from its block's window, the candidate's cell
    in occ3 [H, H, H], t <= t_end."""
    occ3 = np.asarray(occ3)
    Hg = occ3.shape[0]
    idx = np.nonzero(np.asarray(active_blk))[0]
    o = np.asarray(origin, np.float32)
    lo = np.asarray(aabb[:3], np.float32)
    hi = np.asarray(aabb[3:], np.float32)
    d_blocks = np.asarray(d_blocks, np.float32)
    t0_all = np.asarray(t_start_blk, np.float32)
    t1_all = np.asarray(t_end_blk, np.float32)
    ks = np.arange(K2, dtype=np.float32)
    n_real = 0
    for s in range(0, len(idx), chunk):
        sel = idx[s:s + chunk]
        d = d_blocks[sel]                                  # [b, 4, 3]
        t0b = t0_all[sel][:, None]
        t1b = t1_all[sel][:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
        ta = (lo[None, None] - o[None, None]) * inv
        tb = (hi[None, None] - o[None, None]) * inv
        tmin = np.minimum(ta, tb).max(-1)                  # [b, 4]
        tmax = np.maximum(ta, tb).min(-1)
        near = np.maximum(tmin, min_near)
        t_start = np.maximum(near, t0b)
        k0 = np.ceil(np.maximum(t_start - near, 0.0) / dt - 1e-4)
        t_start = near + k0 * dt
        t_end = np.minimum(tmax, t1b)
        t = t_start[..., None] + ks[None, None] * dt       # [b, 4, K2]
        p = o[None, None, None] + t[..., None] * d[:, :, None, :]
        p = np.clip(p, -bound, bound)
        cell = np.clip(((p / bound + 1.0) * (0.5 * Hg)).astype(np.int32),
                       0, Hg - 1)
        hit = occ3[cell[..., 0], cell[..., 1], cell[..., 2]]
        hit &= t <= t_end[..., None]
        n_real += int(hit.any(axis=(1, 2)).sum())
    return n_real


def measure_bucket_plan(settings, z_lo, z_hi, col_dilwords, poses,
                        intrinsics, H: int, W: int, K2: int,
                        k2s_override: int = 0, pose_batch: int = 8,
                        min_saving: float = 0.08, log=print):
    """The short/long bucket plan of the group-2 block march over a
    trajectory: prepass_block_spans over every pose (in batches of
    `pose_batch`), the short bucket's candidate count K2s = the median
    tightened span (made even, clamped to [max_steps, K2 - 2]), and the
    worst per-pose short, long and admitted ray demands.

    Returns (k2s, max_short_rays, max_long_rays, max_admit_rays); k2s == 0
    means one bucket (the modeled saving sum(span <= K2s ? K2s : K2) is
    under `min_saving`, or K2s would reach K2).

    Diverges from the JAX package: `k2s_override` is validated — it must
    be even, at least max_steps and below K2 — and raises ValueError
    otherwise (the JAX version adopts any value unchecked)."""
    from ..utils.rays import get_rays
    from .ray import near_far_from_aabb

    smax = int(settings.max_steps)
    smax += smax % 2
    if k2s_override and (k2s_override % 2 or k2s_override < settings.max_steps
                         or k2s_override >= K2):
        raise ValueError(
            f"k2s_override {k2s_override} must be even, at least max_steps "
            f"({settings.max_steps}) and below K2 ({K2})")
    dev = z_lo.device
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(np.asarray(poses, np.float32).reshape(-1, 4, 4),
                            device=dev)
    P = poses.shape[0]
    adms, spans = [], []
    for s in range(0, P, max(1, pose_batch)):
        pb = poses[s:s + pose_batch]
        rays = get_rays(pb, intrinsics, H, W)
        _, d = block_view(rays["rays_d"], H, W)
        o = rays["rays_o"][:, :1].expand(d.shape)
        d2 = d.reshape(-1, 3)
        o2 = o.reshape(-1, 3)
        nears, fars = near_far_from_aabb(o2, d2, aabb, settings.min_near)
        win = ray_windows(o2, d2, nears, fars, z_lo, z_hi, settings.bound,
                          settings.dt, pad_steps=3.0)
        hit, gf, gl = prepass_block_spans(o2, d2, win.t_start, win.t_end,
                                          col_dilwords, settings.bound,
                                          settings.dt, K2)
        adms.append((hit & win.active).reshape(len(pb), -1).cpu().numpy())
        spans.append((2 * (gl - gf + 1) + 2).reshape(len(pb), -1)
                     .cpu().numpy())
    adm = np.concatenate(adms)                              # [P, NB]
    span = np.concatenate(spans)
    flat = span[adm]
    if not len(flat):
        return 0, 0, 0, 0
    if k2s_override:
        k2s = k2s_override
    else:
        k2s = int(np.median(flat))
        k2s += k2s % 2
        k2s = max(smax, min(k2s, K2 - 2))
        if k2s >= K2:   # the S floor meets K2: a split buys nothing
            return 0, 0, 0, int(adm.sum(axis=1).max()) * 4
        cost = int(np.where(flat <= k2s, k2s, K2).sum())
        if cost > (1.0 - min_saving) * len(flat) * K2:
            log(f"[INFO] bucket march: modeled saving "
                f"{1 - cost / (len(flat) * K2):.1%} < {min_saving:.0%} "
                f"(median span {int(np.median(flat))}, K2 {K2}) — "
                "single-bucket march")
            return 0, 0, 0, int(adm.sum(axis=1).max()) * 4
    short = adm & (span <= k2s)
    n_short = int(short.sum(axis=1).max()) * 4
    n_long = int((adm & ~short).sum(axis=1).max()) * 4
    n_adm = int(adm.sum(axis=1).max()) * 4
    log(f"[INFO] bucket march plan: K2s={k2s} (short demand {n_short}, "
        f"long {n_long}, admitted {n_adm} rays over {P} poses)")
    return k2s, n_short, n_long, n_adm
