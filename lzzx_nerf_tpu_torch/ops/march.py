"""Static-shape occupancy-grid ray marching (port of
lzzx_nerf_tpu/ops/march.py).

In the constant-dt regime (bound <= 1, max_steps <= grid / 2^(C-1)) every
ray visits the fixed lattice t0 + k*dt; the march tests K lattice
candidates against the occupancy grid and keeps each ray's first S
occupied ones, with static shapes throughout."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

SQRT3 = math.sqrt(3.0)


class MarchResult(NamedTuple):
    xyzs: torch.Tensor    # [N, S, 3] sample positions (clamped to ±bound)
    deltas: torch.Tensor  # [N, S] step sizes (dt where valid, else 0)
    ts: torch.Tensor      # [N, S] post-step t (the depth coordinate)
    mask: torch.Tensor    # [N, S] bool, sample slot is a real sample


def marching_dt(bound: float, grid_size: int, max_steps: int,
                cascade: int) -> float:
    """The constant step size of the production config; raises outside
    the constant-dt regime."""
    dt_max = 2.0 * SQRT3 * (1 << (cascade - 1)) / grid_size
    dt_min = min(dt_max, 2.0 * SQRT3 / max_steps)
    if not math.isclose(dt_min, dt_max):
        raise ValueError(
            "march_rays_uniform requires the constant-dt regime "
            f"(dt_min={dt_min} != dt_max={dt_max}); "
            "got max_steps too large for this grid/cascade.")
    return dt_max


def num_candidates(aabb, min_near: float, dt: float) -> int:
    """Static upper bound on lattice points along any ray through the
    aabb."""
    ext = [float(aabb[3] - aabb[0]), float(aabb[4] - aabb[1]),
           float(aabb[5] - aabb[2])]
    diag = math.sqrt(sum(e * e for e in ext))
    return int(math.ceil(diag / dt)) + 1


def occ_lookup(occ_grid: torch.Tensor, flat_idx: torch.Tensor
               ) -> torch.Tensor:
    """Occupancy test for flat cell indices into a [CAS, H, H, H] grid."""
    flat = occ_grid.reshape(-1)
    return flat.index_select(0, flat_idx.reshape(-1).to(torch.int64)
                             ).reshape(flat_idx.shape).to(torch.bool)


def first_s_select(valid: torch.Tensor, num_cand: int, max_samples: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per ray, the lattice indices of the first `max_samples` valid
    candidates, in order -> (sel_k [B, S] float, mask [B, S] bool): the
    JAX package's "topk" mode (the S smallest of a score that is the
    candidate index where valid and num_cand elsewhere)."""
    k = torch.arange(num_cand, dtype=torch.float32, device=valid.device)
    score = torch.where(valid, k[None], float(num_cand))
    sel_k = torch.topk(score, max_samples, dim=1, largest=False,
                       sorted=True).values
    mask = sel_k < num_cand
    return torch.where(mask, sel_k, 0.0), mask


def _lattice_samples(rays_o, rays_d, t0, sel_k, mask, bound: float,
                     dt: float) -> MarchResult:
    t_sel = t0[:, None] + sel_k * dt
    xyzs = rays_o[:, None, :] + t_sel[..., None] * rays_d[:, None, :]
    xyzs = torch.clamp(xyzs, -bound, bound)
    deltas = torch.where(mask, dt, 0.0)
    return MarchResult(xyzs=xyzs, deltas=deltas, ts=t_sel + dt, mask=mask)


def march_rays_uniform(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       nears: torch.Tensor, fars: torch.Tensor,
                       occ_grid: torch.Tensor, bound: float, dt: float,
                       num_cand: int, max_samples: int,
                       noise: Optional[torch.Tensor] = None) -> MarchResult:
    """March all rays over the constant-dt lattice and keep the first
    `max_samples` occupied points per ray.

    rays_o, rays_d [N, 3]; nears, fars [N]; occ_grid [CAS, H, H, H];
    noise [N] in [0, 1) shifts each ray's lattice start by noise * dt.
    Cascades > 1 pick each candidate's mip level from its position and
    the step size, as the JAX package does."""
    cascade, H = occ_grid.shape[0], occ_grid.shape[1]
    if max_samples > num_cand:
        raise ValueError(
            f"max_samples ({max_samples}) cannot exceed the candidate count "
            f"({num_cand}); a ray cannot keep more samples than the lattice "
            "points it tests")
    dev = rays_o.device
    t0 = nears if noise is None else nears + dt * noise
    k = torch.arange(num_cand, dtype=torch.float32, device=dev)
    t_cand = t0[:, None] + k[None, :] * dt                       # [N, K]
    pos = rays_o[:, None, :] + t_cand[..., None] * rays_d[:, None, :]
    pos = torch.clamp(pos, -bound, bound)

    if cascade > 1:
        mx = pos.abs().amax(dim=-1)
        exponent = torch.floor(torch.log2(torch.clamp(mx, min=1e-12))).to(
            torch.int32) + 1
        mip_pos = torch.clamp(exponent, 0, cascade - 1)
        mx_dt = dt * H * 0.5
        mip_dt = max(0, min(cascade - 1, int(math.floor(
            math.log2(max(mx_dt, 1e-12)))) + 1))
        level = torch.clamp(mip_pos, min=mip_dt)
    else:
        level = torch.zeros(pos.shape[:-1], dtype=torch.int32, device=dev)

    mip_bound = torch.clamp(torch.exp2(level.to(torch.float32)), max=bound)
    grid_pos = 0.5 * (pos / mip_bound[..., None] + 1.0) * H
    grid_pos = torch.clamp(grid_pos, 0.0, H - 1).to(torch.int64)
    flat = (level.to(torch.int64) * (H * H * H) + grid_pos[..., 0] * (H * H)
            + grid_pos[..., 1] * H + grid_pos[..., 2])
    valid = occ_lookup(occ_grid, flat) & (t_cand < fars[:, None])
    sel_k, mask = first_s_select(valid, num_cand, max_samples)
    return _lattice_samples(rays_o, rays_d, t0, sel_k, mask, bound, dt)
