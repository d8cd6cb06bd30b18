"""Pose math of the dataset loader (port of the numpy parts of
lzzx_nerf_tpu/utils/pose.py): the dataset-to-renderer axis convention and
trajectory smoothing."""

from __future__ import annotations

import numpy as np


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
