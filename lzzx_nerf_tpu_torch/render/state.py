"""Renderer static settings + occupancy state (port of
lzzx_nerf_tpu/render/state.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class RenderSettings:
    """Static renderer configuration."""

    bound: float = 1.0
    cascade: int = 1
    grid_size: int = 128
    max_steps: int = 16           # S: samples kept per ray
    num_cand: int = 112           # K: lattice candidates per ray
    dt: float = 2.0 * math.sqrt(3.0) / 128
    min_near: float = 0.05
    T_thresh: float = 1e-4
    density_thresh: float = 10.0
    density_thresh_torso: float = 0.01
    density_scale: float = 1.0
    aabb: Tuple[float, float, float, float, float, float] = (
        -1, -0.5, -1, 1, 0.5, 1)
    exp_eye: bool = True
    torso_shrink: float = 0.8

    @staticmethod
    def from_config(cfg) -> "RenderSettings":
        """The settings of a Config (its bound, cascade, grid, S, the
        constant dt and the candidate count of its aabb)."""
        from ..ops.march import marching_dt, num_candidates

        dt = marching_dt(cfg.bound, cfg.grid_size, cfg.max_steps,
                         cfg.cascade)
        aabb = cfg.aabb()
        return RenderSettings(
            bound=cfg.bound, cascade=cfg.cascade, grid_size=cfg.grid_size,
            max_steps=cfg.max_steps,
            num_cand=num_candidates(aabb, cfg.min_near, dt), dt=dt,
            min_near=cfg.min_near, T_thresh=cfg.T_thresh,
            density_thresh=cfg.density_thresh,
            density_thresh_torso=cfg.density_thresh_torso,
            density_scale=cfg.density_scale, aabb=aabb,
            exp_eye=cfg.exp_eye, torso_shrink=cfg.torso_shrink)


class OccupancyState(NamedTuple):
    """Occupancy-grid state."""

    density_grid: torch.Tensor        # [CAS, H, H, H] f32
    occ: torch.Tensor                 # [CAS, H, H, H] bool
    mean_density: torch.Tensor        # scalar f32
    iter_density: torch.Tensor        # scalar i32
    density_grid_torso: torch.Tensor  # [H, H] f32
    mean_density_torso: torch.Tensor  # scalar f32


def init_occupancy_state(settings: RenderSettings,
                         device=None) -> OccupancyState:
    H, C = settings.grid_size, settings.cascade
    return OccupancyState(
        density_grid=torch.zeros((C, H, H, H), device=device),
        occ=torch.zeros((C, H, H, H), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
        density_grid_torso=torch.zeros((H, H), device=device),
        mean_density_torso=torch.zeros((), device=device),
    )
