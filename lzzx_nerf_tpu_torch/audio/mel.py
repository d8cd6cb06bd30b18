"""wav2lip-style mel front-end, librosa-free (numpy + scipy only; the
port's copy of lzzx_nerf_tpu/audio/mel.py).

Re-implements reference data_utils/wav2mel.py + wav2mel_hparams.py exactly:
preemphasis -> centered STFT (hann 800/200/800, reflect pad) -> slaney mel
(80 bands, fmin 65, fmax 6000) -> dB (min level -100, ref 20) -> symmetric
[-4, 4] normalisation -> 25 fps chunks of 8 mel frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
from scipy import signal as sps


@dataclass(frozen=True)
class MelParams:
    sample_rate: int = 16000
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    num_mels: int = 80
    fmin: float = 65.0
    fmax: float = 6000.0
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0
    fps: int = 25
    mel_step_size: int = 8


def _hz_to_mel(f):
    # slaney scale (librosa default, htk=False)
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(log_region,
                   15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                   mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


def mel_filterbank(p: MelParams) -> np.ndarray:
    """[num_mels, n_fft//2+1] slaney-normalised triangular filters
    (equivalent to librosa.filters.mel defaults)."""
    n_bins = p.n_fft // 2 + 1
    fft_freqs = np.linspace(0, p.sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(p.fmin), _hz_to_mel(p.fmax), p.num_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    weights = np.zeros((p.num_mels, n_bins))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(p.num_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalisation
    enorm = 2.0 / (hz_pts[2: p.num_mels + 2] - hz_pts[:p.num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _stft(y: np.ndarray, p: MelParams) -> np.ndarray:
    """Centered magnitude STFT matching librosa.stft defaults:
    reflect-pad by n_fft//2, hann(win_size) zero-padded to n_fft."""
    pad = p.n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    win = sps.get_window("hann", p.win_size, fftbins=True)
    if p.win_size < p.n_fft:
        lpad = (p.n_fft - p.win_size) // 2
        win = np.pad(win, (lpad, p.n_fft - p.win_size - lpad))
    n_frames = 1 + (len(y) - p.n_fft) // p.hop_size
    idx = (np.arange(p.n_fft)[None, :]
           + p.hop_size * np.arange(n_frames)[:, None])
    frames = y[idx] * win[None, :]
    return np.abs(np.fft.rfft(frames, n=p.n_fft, axis=-1)).T  # [bins, T]


def melspectrogram(wav: np.ndarray, p: MelParams = MelParams()) -> np.ndarray:
    """wav (16 kHz float) -> normalised mel [num_mels, T] in [-4, 4]."""
    if p.preemphasis > 0:
        wav = sps.lfilter([1.0, -p.preemphasis], [1.0], wav)
    S = _stft(np.asarray(wav, np.float64), p)
    mel = mel_filterbank(p) @ S
    min_level = np.exp(p.min_level_db / 20 * np.log(10))
    db = 20 * np.log10(np.maximum(min_level, mel)) - p.ref_level_db
    # symmetric clip-normalise (wav2mel.py:95-101)
    out = np.clip(
        (2 * p.max_abs_value) * ((db - p.min_level_db) / (-p.min_level_db))
        - p.max_abs_value, -p.max_abs_value, p.max_abs_value)
    return out.astype(np.float32)


def wav_to_mel_chunks(wav: np.ndarray, sr: int = 16000,
                      p: MelParams = MelParams()) -> List[np.ndarray]:
    """25 fps sliding chunks of 8 mel frames (wav2mel.py:125-147).
    Returns a list of [num_mels, mel_step_size] arrays."""
    if sr != p.sample_rate:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, p.sample_rate)
        wav = resample_poly(wav, p.sample_rate // g, sr // g)
    mel = melspectrogram(wav, p)
    if np.isnan(mel).any():
        raise ValueError("mel contains NaN — add epsilon noise to the wav")
    if mel.shape[1] < p.mel_step_size:
        # sub-90 ms wav: the T-mel_step_size tail slice below would go
        # negative and yield ragged [num_mels, T] chunks — right-pad with
        # the quietest frame so every chunk keeps the contract shape
        pad = np.tile(mel.min(axis=1, keepdims=True),
                      (1, p.mel_step_size - mel.shape[1]))
        mel = np.concatenate([mel, pad], axis=1)
    chunks = []
    mult = 80.0 / p.fps
    half = p.mel_step_size // 2
    T = mel.shape[1]
    i = start = 0
    # NOTE the stale-start loop test is reference-exact (wav2mel.py:138-147):
    # the final tail chunk is appended 1-2x extra before `start` catches up.
    # Consumers zip chunks with video frames, so surplus tail chunks drop.
    while start < T:
        start = int(i * mult)
        if start + half > T:
            chunks.append(mel[:, T - p.mel_step_size:])
        elif start - half < 0:
            chunks.append(mel[:, :p.mel_step_size])
        else:
            chunks.append(mel[:, start - half: start + half])
        i += 1
    return chunks
