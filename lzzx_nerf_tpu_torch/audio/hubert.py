"""HuBERT audio feature extraction (the port's copy of
lzzx_nerf_tpu/audio/hubert.py; reference data_utils/HubertBean.py:32-114,
data_utils/hubert.py).

Wraps the transformers HuBERT (torch, offline) with the reference's
CNN-aware chunking: the feature CNN is equivalent to one Conv1d(k=400, s=320),
so long audio is processed in clips of stride*1000 samples with a
(kernel-stride) rollback, then reshaped [T, 1024] -> [T//2, 2, 1024] so each
row holds two 20 ms steps == one 25 fps video frame.

It runs on "cuda" unless the caller names another device (the server passes
its session's device). In a zero-egress environment the pretrained weights must already be on disk; point
`model_path` at the local checkout or set HF_HOME. Without weights the class
raises at construction with a clear message (the rest of the framework —
training/rendering on precomputed .npy features — is unaffected).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

KERNEL = 400
STRIDE = 320
CLIP = STRIDE * 1000


class HubertFeatureExtractor:
    def __init__(self, model_path: str = "facebook/hubert-large-ls960-ft",
                 device=None):
        try:
            import torch  # noqa
            from transformers import HubertModel, Wav2Vec2Processor
        except ImportError as e:
            raise RuntimeError(f"transformers/torch unavailable: {e}")
        from ..utils.device import resolve_device

        device = resolve_device(device)
        try:
            self.processor = Wav2Vec2Processor.from_pretrained(model_path)
            self.model = HubertModel.from_pretrained(model_path)
        except Exception as e:
            raise RuntimeError(
                f"could not load HuBERT weights from '{model_path}' "
                f"(offline environment? pre-download or pass a local path): {e}")
        self.device = device
        self.model.to(device).eval()

    def hidden_states(self, speech16k: np.ndarray) -> np.ndarray:
        """16 kHz mono float wav -> [T, 1024] hidden states
        (HubertBean.py:32-82 chunking)."""
        import torch

        if speech16k.ndim == 2:
            speech16k = speech16k[:, 0]
        values = self.processor(speech16k, return_tensors="pt",
                                sampling_rate=16000).input_values
        values = values.to(self.device)
        total = values.shape[1]
        if total < KERNEL:
            raise ValueError(
                f"audio too short for the HuBERT CNN: {total} samples "
                f"< kernel {KERNEL} (~{KERNEL / 16000 * 1000:.0f} ms)")
        num_iter = total // CLIP
        expected_T = (total - (KERNEL - STRIDE)) // STRIDE
        chunks = []
        with torch.no_grad():
            for i in range(num_iter):
                start = 0 if i == 0 else CLIP * i
                end = (CLIP - STRIDE + KERNEL) if i == 0 else (
                    start + CLIP - STRIDE + KERNEL)
                chunks.append(self.model(values[:, start:end])
                              .last_hidden_state[0])
            tail = values[:, CLIP * num_iter:] if num_iter > 0 else values
            if tail.shape[1] >= KERNEL:
                chunks.append(self.model(tail).last_hidden_state[0])
        ret = torch.cat(chunks, dim=0)
        assert abs(ret.shape[0] - expected_T) <= 1
        if ret.shape[0] < expected_T:
            ret = torch.nn.functional.pad(
                ret, (0, 0, 0, expected_T - ret.shape[0]))
        return ret[:expected_T].cpu().numpy()

    def features(self, speech16k: np.ndarray) -> np.ndarray:
        """-> [T//2, 2, 1024] per-video-frame features (HubertBean.py:90-114,
        the layout stored as aud_hu.npy and fed to AudioNet)."""
        h = self.hidden_states(speech16k)
        if h.shape[0] % 2 == 1:
            h = h[:-1]
        return h.reshape(-1, 2, 1024)

    def features_from_wav(self, wav_path: str) -> np.ndarray:
        sr, data = _read_wav(wav_path)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        if sr != 16000:
            from math import gcd

            from scipy.signal import resample_poly

            g = gcd(sr, 16000)
            data = resample_poly(data, 16000 // g, sr // g, axis=0)
        return self.features(np.asarray(data, np.float32))


class HubertStreamer:
    """Sample-lattice carry for LIVE pcm chunks: HuBERT's stride lattice
    (kernel 400 / stride 320; 2 steps = 1 video frame = 640 samples)
    continues across arbitrary chunk boundaries instead of restarting per
    chunk — per-chunk extraction discards up to ~520 samples/chunk
    (~1 frame/s of cumulative A/V drift at 1 s chunks). push() returns
    whole-frame features or None while buffering; flush() ends the stream
    (the sub-frame remainder matches what the offline extractor's own
    odd-step truncation drops — see flush()). The transformer context still resets
    per push — the same bounded discontinuity the reference's streaming
    ASR accepts via its (l, m, r) windows (asr.py:56-66). Consumers:
    webapi /api/audio_chunk."""

    FRAME = 640        # samples per video frame (2 steps x stride 320)
    EDGE = 80          # CNN kernel overhang (kernel 400 - stride 320)

    def __init__(self, extractor: "HubertFeatureExtractor"):
        self.extractor = extractor
        self._rem: Optional[np.ndarray] = None

    def push(self, pcm: np.ndarray) -> Optional[np.ndarray]:
        buf = (np.asarray(pcm, np.float32) if self._rem is None
               else np.concatenate([self._rem, pcm]))
        k = max(0, (len(buf) - self.EDGE) // self.FRAME)
        if k == 0:
            self._rem = buf
            return None
        feats = self.extractor.features(buf[:self.FRAME * k + self.EDGE])
        self._rem = buf[self.FRAME * k:]   # keep the CNN edge overlap
        return feats

    def flush(self) -> Optional[np.ndarray]:
        """End of stream. The carried remainder is always < FRAME + EDGE
        = 720 samples — less than one whole video frame — and the OFFLINE
        extractor drops exactly the same sub-frame tail (features() odd-
        step truncation), so there is never anything to emit: chunked
        frame count already equals the whole-utterance count. Returns
        None; kept as an explicit end-of-stream API so the invariant is
        stated in one place."""
        self._rem = None
        return None

    def feature_stream(self, chunks):
        """Generator form for run_live: yields whole-frame feature blocks
        as pcm chunks arrive, then the flushed tail."""
        for chunk in chunks:
            feats = self.push(chunk)
            if feats is not None:
                yield feats
        feats = self.flush()
        if feats is not None:
            yield feats


def _read_wav(path: str):
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return sr, data
