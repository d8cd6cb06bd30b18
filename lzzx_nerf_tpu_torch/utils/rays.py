"""Ray generation (port of lzzx_nerf_tpu/utils/rays.py: all pixels, or
the pixels a training step draws).

Same pixel convention as the JAX package: pixel centres at +0.5, pinhole
model, directions normalised then rotated by the c2w rotation."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def get_bg_coords(H: int, W: int, device=None) -> torch.Tensor:
    """[1, H*W, 2] in [-1, 1] — coords[..., 0] spans rows (H), [..., 1]
    cols."""
    X = torch.arange(H, dtype=torch.float32, device=device) / (H - 1) * 2 - 1
    Y = torch.arange(W, dtype=torch.float32, device=device) / (W - 1) * 2 - 1
    xs, ys = torch.meshgrid(X, Y, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)[None]


def patch_inds(H: int, W: int, N: int, patch_size: int,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """The pixels of a patch-sampled step (the JAX package's get_rays with
    patch_size > 1): N // p² patches of p x p pixels, their row origins
    drawn in [0, H - p) and then their column origins in [0, W - p) (upper
    bounds exclusive, as in the reference), the offsets row-major, so ray
    k·p² + a·p + b is pixel (x_k + a, y_k + b). -> [N // p² · p²] flat
    row-major indices."""
    p = patch_size
    num_patch = min(N, H * W) // (p * p)
    xs = torch.randint(0, H - p, (num_patch,), generator=generator,
                       device=device)
    ys = torch.randint(0, W - p, (num_patch,), generator=generator,
                       device=device)
    a = torch.arange(p, device=xs.device)
    rows = xs[:, None, None] + a[None, :, None]
    cols = ys[:, None, None] + a[None, None, :]
    return (rows * W + cols).reshape(-1)


def get_rays(poses: torch.Tensor, intrinsics, H: int, W: int,
             inds: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Rays of each pose through the pixels `inds` (flat row-major
    indices, drawn by the caller: the JAX package's random-N mode), all
    H*W pixels when None. poses [B, 4, 4] c2w -> dict(rays_o,
    rays_d [B, n, 3])."""
    dev = poses.device
    # float32 values as Python scalars: no host-to-device copy, so the
    # frame records into a CUDA graph
    fx, fy, cx, cy = [float(np.float32(v)) for v in intrinsics]
    if inds is None:
        inds = torch.arange(H * W, device=dev)
    i = (inds % W).to(torch.float32) + 0.5
    j = torch.div(inds, W, rounding_mode="floor").to(torch.float32) + 0.5
    zs = torch.ones_like(i)
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = torch.stack([xs, ys, zs], dim=-1)
    directions = directions / torch.linalg.vector_norm(
        directions, dim=-1, keepdim=True)
    rays_d = torch.einsum("nk,bjk->bnj", directions, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o, "rays_d": rays_d}


def min_corner_dz(poses, intrinsics, H: int, W: int) -> float:
    """Smallest |world z| direction component over every pose's frame-corner
    rays (host-side numpy; poses [F, 4, 4] or [4, 4])."""
    p = np.asarray(poses, np.float32)
    if p.ndim == 2:
        p = p[None]
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    ii = np.array([0.5, W - 0.5, 0.5, W - 0.5], np.float32)
    jj = np.array([0.5, 0.5, H - 0.5, H - 0.5], np.float32)
    d = np.stack([(ii - cx) / fx, (jj - cy) / fy, np.ones(4, np.float32)],
                 -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    world = np.einsum("nk,fjk->fnj", d, p[:, :3, :3])
    return float(np.abs(world[..., 2]).min())
