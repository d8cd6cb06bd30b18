"""Audio feature windowing (port of lzzx_nerf_tpu/utils/audio.py).

`get_audio_features(features, att_mode, index)` selects the attention
context of frame `index` from the per-frame feature array:
  mode 0: just the frame                      -> [1, ...]
  mode 1: 8 frames ending at index (left pad) -> [8, ...]
  mode 2: 8 frames centred at index (pad both)-> [8, ...]
Out-of-range slots are zeros. Host-side numpy, like the data loaders that
call it."""

from __future__ import annotations

from typing import Optional

import numpy as np


def window_offsets(att_mode: int) -> Optional[np.ndarray]:
    """Frame offsets of the attention window relative to `index`; None
    means mode 0 (just the frame itself)."""
    if att_mode == 0:
        return None
    if att_mode == 1:
        return np.arange(-8, 0, dtype=np.int32)
    if att_mode == 2:
        return np.arange(-4, 4, dtype=np.int32)
    raise NotImplementedError(f"wrong att_mode: {att_mode}")


def get_audio_features(features: np.ndarray, att_mode: int,
                       index: int) -> np.ndarray:
    """features [F, ...] -> [1, ...] (mode 0) or [8, ...] (modes 1/2):
    a clamped gather, zero-masked where the window leaves [0, F)."""
    F = features.shape[0]
    offsets = window_offsets(att_mode)
    if offsets is None:
        return features[int(index)][None]
    idx = int(index) + offsets
    valid = (idx >= 0) & (idx < F)
    win = features[np.clip(idx, 0, F - 1)]
    shape = (8,) + (1,) * (features.ndim - 1)
    return win * valid.astype(features.dtype).reshape(shape)


def get_audio_features_np(features: np.ndarray, att_mode: int,
                          index: int) -> np.ndarray:
    """The data loader's window: get_audio_features with `index` clamped
    to the last frame (the JAX package's host-side twin)."""
    return get_audio_features(features, att_mode,
                              min(int(index), features.shape[0] - 1))
