"""Occupancy-grid maintenance (port of lzzx_nerf_tpu/render/grid_update.py:
update_density_grid, the head refresh of make_density_grid_update,
update_torso_grid and its refresh make_torso_grid_update, and
mark_untrained_grid).

The jitter of a refresh is an explicit input: one [H^3, 3] uniform draw in
[0, 1) per cascade for the head, one [H^2, 2] draw for the torso, from a
generator or given by the caller (the parity tests pass the JAX package's
draws)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.nn import functional as F

from ..ops.morton import dilate_grid3d
from .state import OccupancyState, RenderSettings

# points per field query of a refresh: bounds the activations of one
# density eval (at grid 128 a cascade is 2,097,152 points, queried in 4
# chunks)
REFRESH_CHUNK = 1 << 19


def _cell_coords(H: int, device=None) -> torch.Tensor:
    """[H^3, 3] integer cell coords in natural (x, y, z) order."""
    r = torch.arange(H, dtype=torch.int64, device=device)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def refresh_jitter(settings: RenderSettings, generator: torch.Generator,
                   device=None) -> list:
    """One refresh's cell jitter: a [H^3, 3] uniform draw per cascade."""
    H, C = settings.grid_size, settings.cascade
    return [torch.rand((H ** 3, 3), generator=generator, device=device)
            for _ in range(C)]


@torch.no_grad()
def update_density_grid(density_fn: Callable[[torch.Tensor], torch.Tensor],
                        settings: RenderSettings, state: OccupancyState,
                        jitter: Sequence[torch.Tensor], decay: float = 0.95,
                        chunk: int = REFRESH_CHUNK) -> OccupancyState:
    """One head-grid refresh: query density at every jittered cell of each
    cascade, dilate (6-neighbour cross), EMA-max with the old grid where
    both are >= 0 (-1 marks untrained cells), re-threshold the occupancy at
    min(mean density, density_thresh).

    density_fn(pts [M, 3]) -> sigma [M]; jitter: refresh_jitter's draws.
    The query runs in chunks of `chunk` points."""
    H, C = settings.grid_size, settings.cascade
    dev = state.density_grid.device
    xyzs = 2.0 * _cell_coords(H, dev).to(torch.float32) / (H - 1) - 1.0
    cas_grids = []
    for cas in range(C):
        bound = min(2 ** cas, settings.bound)
        half = bound / H
        pts = xyzs * (bound - half) + (jitter[cas] * 2.0 - 1.0) * half
        sigma = torch.cat([density_fn(pts[i:i + chunk])
                           for i in range(0, pts.shape[0], chunk)])
        cas_grids.append((sigma * settings.density_scale).reshape(H, H, H))
    tmp = dilate_grid3d(torch.stack(cas_grids, dim=0))
    old = state.density_grid
    valid = (old >= 0) & (tmp >= 0)
    new_grid = torch.where(valid, torch.maximum(old * decay, tmp), old)
    mean_density = torch.mean(torch.clamp(new_grid, min=0.0))
    thresh = torch.clamp(mean_density, max=settings.density_thresh)
    return state._replace(density_grid=new_grid, occ=new_grid > thresh,
                          mean_density=mean_density,
                          iter_density=state.iter_density + 1)


def make_density_grid_update(field, settings: RenderSettings,
                             decay: float = 0.95):
    """The every-16-steps head refresh: refresh(state, auds, eye,
    generator=None, jitter=None) -> state. Encodes the audio window, bakes
    the field's tables once and queries the field's density on the
    jittered cells (update_density_grid). jitter replaces the generator's
    draws."""

    @torch.no_grad()
    def refresh(state: OccupancyState, auds: torch.Tensor, eye,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[Sequence[torch.Tensor]] = None
                ) -> OccupancyState:
        dev = state.density_grid.device
        if jitter is None:
            if generator is None:
                raise ValueError("refresh needs a generator or the jitter")
            jitter = refresh_jitter(settings, generator, dev)
        enc_a = field.encode_audio_train(auds)
        packed = field.bake_train_tables()

        def density_fn(pts):
            return field.density(pts, enc_a, eye, packed=packed).sigma

        return update_density_grid(density_fn, settings, state, jitter,
                                   decay=decay)

    return refresh


@torch.no_grad()
def update_torso_grid(torso_alpha_fn: Callable, settings: RenderSettings,
                      state: OccupancyState, pose: torch.Tensor,
                      ind_code_torso: Optional[torch.Tensor],
                      jitter: torch.Tensor, decay: float = 0.95
                      ) -> OccupancyState:
    """One torso-grid refresh: the torso's alpha at every jittered cell of
    the 2-D lattice, a 5x5 max-pool dilation (stride 1, padded with -inf),
    EMA-max with the old grid; mean_density_torso is the plain mean.

    torso_alpha_fn(xys [M, 2], pose, code) -> alpha [M]; jitter: the
    cells' [H^2, 2] uniform draw. The value of cell (c0, c1) lands at row
    c1, column c0 (the reference's transposed flat index, matching the
    lookup's grid_sample convention)."""
    H = settings.grid_size
    dev = state.density_grid_torso.device
    r = torch.arange(H, device=dev)
    cx, cy = torch.meshgrid(r, r, indexing="ij")
    coords = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
    half = 1.0 / H
    xys = (2.0 * coords.to(torch.float32) / (H - 1) - 1.0) * (1.0 - half)
    xys = xys + (jitter * 2.0 - 1.0) * half
    alphas = torso_alpha_fn(xys, pose, ind_code_torso)
    tmp = torch.zeros((H, H), device=dev)
    tmp[coords[:, 1], coords[:, 0]] = alphas
    # max_pool2d pads with -inf, as the reference's reduce_window "SAME"
    tmp = F.max_pool2d(tmp[None, None], 5, stride=1, padding=2)[0, 0]
    new = torch.maximum(state.density_grid_torso * decay, tmp)
    return state._replace(density_grid_torso=new,
                          mean_density_torso=torch.mean(new))


def make_torso_grid_update(torso, settings: RenderSettings,
                           ind_dim_torso: int, decay: float = 0.95):
    """The every-16-steps torso refresh: refresh(state, pose,
    generator=None, jitter=None) -> state. Bakes the torso table once and
    queries its alpha with individual code 0 (the JAX refresh's code, not
    the frame's). jitter replaces the generator's draw."""

    @torch.no_grad()
    def refresh(state: OccupancyState, pose: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[torch.Tensor] = None) -> OccupancyState:
        dev = state.density_grid_torso.device
        if jitter is None:
            if generator is None:
                raise ValueError("refresh needs a generator or the jitter")
            H = settings.grid_size
            jitter = torch.rand((H * H, 2), generator=generator, device=dev)
        c = torso.individual_codes_torso[0] if ind_dim_torso > 0 else None
        packed = torso.bake_train_table()

        def alpha_fn(xys, pose_, cc):
            return torso.train_forward(xys, pose_, cc, packed)[0][:, 0]

        return update_torso_grid(alpha_fn, settings, state, pose, c, jitter,
                                 decay=decay)

    return refresh


@torch.no_grad()
def mark_untrained_grid(settings: RenderSettings, state: OccupancyState,
                        poses: torch.Tensor, intrinsics, chunk: int = 64
                        ) -> OccupancyState:
    """Mark the cells no training camera sees as -1. poses [B, 4, 4] c2w
    (the rotation is used untransposed, as in the reference), counted in
    chunks of `chunk` poses."""
    H, C = settings.grid_size, settings.cascade
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    dev = state.density_grid.device
    world = 2.0 * _cell_coords(H, dev).to(torch.float32) / (H - 1) - 1.0
    poses = poses.to(device=dev, dtype=torch.float32)
    counts = []
    for cas in range(C):
        bound = min(2 ** cas, settings.bound)
        half = bound / H
        pts = world * (bound - half)
        cnt = torch.zeros(pts.shape[0], dtype=torch.int64, device=dev)
        for i in range(0, poses.shape[0], chunk):
            pc = poses[i:i + chunk]
            rel = pts[None, :, :] - pc[:, None, :3, 3]
            cam = torch.einsum("cmi,cij->cmj", rel, pc[:, :3, :3])
            vis = ((cam[..., 2] > 0)
                   & (cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2)
                   & (cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2))
            cnt += vis.sum(dim=0)
        counts.append(cnt.reshape(H, H, H))
    count = torch.stack(counts, dim=0)
    return state._replace(density_grid=torch.where(
        count == 0, torch.full_like(state.density_grid, -1.0),
        state.density_grid))
