"""Pose math of the dataset loader (port of the numpy parts of
lzzx_nerf_tpu/utils/pose.py): the dataset-to-renderer axis convention,
trajectory smoothing, and the Euler-angle rotation of the learned
per-frame pose refinement (train_camera)."""

from __future__ import annotations

import numpy as np
import torch


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 4.0,
                       offset=(0, 0, 0)) -> np.ndarray:
    """Axis swap + scale from the dataset's convention to the renderer's:
    new_pose rows are built from the original with y/z swapped and the
    translation scaled by `scale` plus `offset`."""
    return np.array([
        [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
        [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
        [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Sliding-window average of a [B, 4, 4] pose trajectory: the mean
    translation and the SVD-projected mean rotation (the chordal L2 mean)."""
    B = poses.shape[0]
    out = poses.copy()
    for i in range(B):
        lo, hi = max(0, i - kernel_size // 2), min(B, i + kernel_size // 2 + 1)
        out[i, :3, 3] = poses[lo:hi, :3, 3].mean(0)
        R = poses[lo:hi, :3, :3].mean(0)
        U, _, Vt = np.linalg.svd(R)
        S = np.eye(3)
        S[2, 2] = np.sign(np.linalg.det(U @ Vt))
        out[i, :3, :3] = U @ S @ Vt
    return out


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(axis)
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """[..., 3] radians -> [..., 3, 3] rotation, the product of the three
    axis rotations in `convention` order."""
    mats = [_axis_angle_rotation(c, euler[..., i])
            for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def camera_refinement(camera_dR: torch.Tensor, camera_dT: torch.Tensor,
                      index) -> tuple:
    """The learned refinement of frame `index` (an int or an index
    tensor): (dR [..., 3, 3], dT [..., 3]); rays move as
    rays_o + dT, rays_d @ dR."""
    if not torch.is_tensor(index):
        index = torch.tensor(index, device=camera_dR.device)
    dR = euler_angles_to_matrix(
        camera_dR.index_select(0, index.reshape(-1)) / 180.0 * np.pi + 1e-8)
    dT = camera_dT.index_select(0, index.reshape(-1))
    shape = index.shape
    return dR.reshape(shape + (3, 3)), dT.reshape(shape + (3,))
