"""LPIPS with the AlexNet backbone (port of lzzx_nerf_tpu/train/lpips.py).

AlexNet conv features tapped after each ReLU, each tap normalised over its
channels, squared difference, a non-negative per-channel linear head,
spatial mean, summed over the five taps. Inputs are [-1, 1] RGB, shifted
and scaled by the LPIPS constants.

Weights come in the JAX package's npz layout (conv0..conv4 as HWIO
kernels, bias0..bias4, lin0..lin4; scripts/export_lpips.py writes it). The
layout is converted once at load time: kernels to PyTorch's OIHW. Inputs
keep the JAX package's [B, H, W, 3] and are permuted to NCHW once. Without
an npz, random_params builds the fixed-seed random backbone of the JAX
package from the same numpy draws (bit-equal), whose distances are not
comparable to official LPIPS numbers. The port sets
torch.backends.cudnn.allow_tf32 = False on import (as models/audio.py
does): the float32 convolutions must not run in TF32.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn import functional as F

torch.backends.cudnn.allow_tf32 = False

# (out_ch, kernel, stride, pad) per AlexNet feature conv
_ALEX = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # maxpool(k3, s2, VALID) after taps 0 and 1

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/lzzx/lpips_alex.npz")


def _to_torch(arrays: Mapping[str, np.ndarray],
              device=None) -> Dict[str, torch.Tensor]:
    """npz-layout arrays -> float32 tensors, conv kernels HWIO -> OIHW."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v, np.float32)
        if k.startswith("conv"):
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def random_params(seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """He-init backbone + uniform lin heads, drawn from
    np.random.default_rng(seed) in the JAX package's order (bit-equal to
    its random_params)."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX):
        fan_in = in_ch * k * k
        params[f"conv{i}"] = (
            rng.standard_normal((k, k, in_ch, out_ch)) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        params[f"bias{i}"] = np.zeros(out_ch, np.float32)
        params[f"lin{i}"] = (rng.uniform(0, 1, (out_ch,))
                             / out_ch).astype(np.float32)
        in_ch = out_ch
    return _to_torch(params, device)


def load_weights(path: str, device=None) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return _to_torch({k: data[k] for k in data.files}, device)


def default_weights_path() -> Optional[str]:
    """First existing candidate: $LZZX_LPIPS_NPZ, then the cache default."""
    for cand in (os.environ.get("LZZX_LPIPS_NPZ"), DEFAULT_WEIGHTS):
        if cand and os.path.exists(cand):
            return cand
    return None


def get_params(path: Optional[str] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """An explicit path must exist. No path: the default weights if
    present, else the fixed-seed random backbone (is_pretrained() reports
    which, with the same precedence)."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"LPIPS weights not found: {path}")
        return load_weights(path, device)
    default = default_weights_path()
    if default:
        return load_weights(default, device)
    return random_params(device=device)


def is_pretrained(path: Optional[str] = None) -> bool:
    if path:
        return os.path.exists(path)
    return default_weights_path() is not None


def _features(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> list:
    """x [B, H, W, 3] in [-1, 1] -> the five tap activations, NCHW."""
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    for i, (_, k, s, p) in enumerate(_ALEX):
        h = F.relu(F.conv2d(h, params[f"conv{i}"], params[f"bias{i}"],
                            stride=s, padding=p))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return taps


def lpips(params: Mapping[str, torch.Tensor], x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """Perceptual distance per batch element: x, y [B, H, W, 3] in [-1, 1]
    -> [B]. H and W must be >= 32 (the conv/pool stack collapses smaller
    inputs to zero size); pad a smaller crop, as the lips rect does."""
    if x.shape[1] < 32 or x.shape[2] < 32:
        raise ValueError(
            f"lpips needs patches >= 32x32, got {x.shape[1]}x{x.shape[2]} "
            "(pad the crop like the reference lips rect)")
    total = 0.0
    for i, (a, b) in enumerate(zip(_features(params, x),
                                   _features(params, y))):
        # sqrt(sum + eps), not a norm: the norm's gradient at an all-zero
        # feature vector (every ReLU of a pixel dead) is nan
        na = a / torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True) + 1e-12)
        nb = b / torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True) + 1e-12)
        w = torch.clamp(params[f"lin{i}"], min=0.0)     # non-negative heads
        d = torch.sum((na - nb) ** 2 * w[None, :, None, None], dim=1)
        total = total + torch.mean(d, dim=(1, 2))
    return total
