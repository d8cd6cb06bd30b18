"""Procedural synthetic talking-head dataset (port of
lzzx_nerf_tpu/data/synthetic.py).

An analytically rendered Lambertian sphere "head" whose radius breathes
with a sine "audio" signal, with camera orbits and eye-state modulation:
the training oracle. Frames are numpy arrays in the trainer's batch layout
(full-frame image/masks/bg + pose + windowed audio features), equal to the
JAX package's for the same size and seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..utils.audio import get_audio_features


def _linspace_f32(n: int) -> np.ndarray:
    """linspace(-1, 1, n) in float32 by the JAX formula
    start * (1 - s) + stop * s, s = i / (n - 1), endpoint appended."""
    div = n - 1
    s = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(-1.0) * (np.float32(1.0) - s) + np.float32(1.0) * s
    return np.concatenate([out, np.ones(1, np.float32)]).astype(np.float32)


def two_blob_occupancy(grid_size: int, device=None) -> torch.Tensor:
    """Sparse test occupancy [1, G, G, G] bool: a main head-sized blob plus
    a small far-z satellite (central rays cross both, silhouette rays
    one)."""
    r = torch.from_numpy(_linspace_f32(grid_size)).to(device)
    X, Y, Z = torch.meshgrid(r, r, r, indexing="ij")
    blob = torch.sqrt(X ** 2 + (2 * Y) ** 2 + Z ** 2) < 0.45
    blob = blob | (torch.sqrt(X ** 2 + (2 * Y) ** 2
                              + ((Z + 0.72) * 2) ** 2) < 0.22)
    return blob[None]


@dataclass
class SyntheticTalkingHead:
    num_frames: int = 32
    H: int = 64
    W: int = 64
    audio_dim: int = 29            # deepspeech-like
    audio_window: int = 16
    att_mode: int = 2
    radius_base: float = 0.35
    radius_amp: float = 0.08
    cam_dist: float = 2.5
    seed: int = 0
    torso: bool = False            # add a shoulders plate (torso-stage target)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        t = np.arange(self.num_frames, dtype=np.float32)
        # "audio": a sine amplitude track embedded in a random linear map
        self.amplitude = 0.5 + 0.5 * np.sin(2 * np.pi * t / 16.0)      # [F]
        proj = rng.standard_normal((1, self.audio_dim)).astype(np.float32)
        feats = self.amplitude[:, None] * proj                          # [F, C]
        # per-frame feature window [F, win, C] (constant within the window,
        # like repeated ASR logits)
        self.aud_features = np.repeat(feats[:, None, :], self.audio_window, 1)
        self.eye_area = (0.15 + 0.1 * np.cos(2 * np.pi * t / 8.0)).astype(
            np.float32)                                                 # [F]
        # camera orbit: small azimuth sweep at fixed distance, looking at 0
        self.azimuths = np.deg2rad(20.0 * np.sin(2 * np.pi * t / self.num_frames))
        fov = 0.6
        self.intrinsics = (self.W / fov, self.W / fov, self.W / 2, self.H / 2)

    def radius(self, f: int) -> float:
        return self.radius_base + self.radius_amp * float(self.amplitude[f])

    def pose(self, f: int) -> np.ndarray:
        az = float(self.azimuths[f])
        # camera position on the z<0 arc, looking at the origin, y up
        cpos = np.array([np.sin(az), 0.0, -np.cos(az)]) * self.cam_dist
        fwd = -cpos / np.linalg.norm(cpos)           # camera +z looks at origin
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, upv, fwd, cpos
        return c2w

    def _render_analytic(self, f: int) -> Dict[str, np.ndarray]:
        """Ray-trace the sphere analytically: Lambertian grey head, eye-state
        modulated tint, white background."""
        H, W = self.H, self.W
        fx, fy, cx, cy = self.intrinsics
        i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5,
                           indexing="xy")
        d = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        c2w = self.pose(f)
        rd = d @ c2w[:3, :3].T
        ro = c2w[:3, 3]

        r = self.radius(f)
        b = np.einsum("hwc,c->hw", rd, ro)
        c = float(ro @ ro) - r * r
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= t > 0

        p = ro + t[..., None] * rd
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-8)
        light = np.array([0.5, 0.7, -0.5])
        light = light / np.linalg.norm(light)
        lam = np.clip(np.einsum("hwc,c->hw", n, light), 0.1, 1.0)
        tint = np.array([0.8, 0.6 + 0.3 * self.eye_area[f], 0.55])
        img = np.ones((H, W, 3), np.float32)
        if self.torso:
            img = self._torso_plate(f)
        img[hit] = (lam[hit, None] * tint).astype(np.float32)
        return {"image": img, "mask": hit}

    def _torso_plate(self, f: int) -> np.ndarray:
        """Torso-over-background composite: a rounded-shoulders plate in the
        lower third whose horizontal offset follows the camera azimuth and
        whose color breathes with the audio amplitude — a signal the
        TorsoField (screen-xy + pose + per-frame code) can actually learn.
        Mirrors the dataset's bg_torso composite (provider.py:292-295)."""
        H, W = self.H, self.W
        i, j = np.meshgrid((np.arange(W) + 0.5) / W,
                           (np.arange(H) + 0.5) / H, indexing="xy")
        xoff = 0.08 * np.sin(self.azimuths[f] / np.deg2rad(20.0) * np.pi / 2)
        # shoulders: a super-ellipse centered below the frame bottom
        sx, sy = (i - 0.5 - xoff) / 0.42, (j - 1.15) / 0.55
        inside = sx ** 2 + sy ** 2 < 1.0
        shade = np.clip(1.0 - 0.6 * (sx ** 2 + sy ** 2), 0.2, 1.0)
        tint = np.array([0.25, 0.3 + 0.1 * self.amplitude[f], 0.45],
                        np.float32)
        img = np.ones((H, W, 3), np.float32)
        img[inside] = (shade[inside, None] * tint).astype(np.float32)
        return img

    def frame(self, f: int) -> Dict[str, np.ndarray]:
        """Batch dict in trainer layout."""
        rendered = self._render_analytic(f)
        face_mask = rendered["mask"]
        out_extra = {}
        if self.torso:
            # head stage renders over the torso composite; torso stage
            # regresses the composite itself (trainer.py:404-455)
            out_extra["bg_torso_color"] = self._torso_plate(f)
        return {
            "image": rendered["image"],
            "bg_color": (out_extra["bg_torso_color"] if self.torso
                         else np.ones((self.H, self.W, 3), np.float32)),
            "face_mask": face_mask,
            "pose": self.pose(f),
            **out_extra,
            "auds": get_audio_features(self.aud_features, self.att_mode,
                                       f),
            "eye": np.asarray([self.eye_area[f]], np.float32),
            "index": np.int32(f),
        }

    def frames(self):
        for f in range(self.num_frames):
            yield self.frame(f)
