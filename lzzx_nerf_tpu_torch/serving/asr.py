"""Streaming ASR feature pipeline for live audio-driven rendering (the
port's copy of lzzx_nerf_tpu/serving/asr.py).

Re-design of reference nerf_triplane/asr.py (and its offline twin
data_utils/wav2vec.py): 20 ms chunks flow through a (left=10, mid=50,
right=10)-chunk sliding context into a wav2vec2-CTC model; per-step logits
land in a constant-memory ring buffer from which 16-step windows (stride 2)
feed the renderer's 8-frame attention.

Structure here separates three concerns the reference interleaves:
- `FeatureRing` — the ring buffer + windowing state machine (pure numpy,
  fully testable without any model or microphone).
- `StreamingASR` — chunk accumulation + stride trimming around a pluggable
  `feature_fn(samples) -> [T, C]` (the transformers CTC model in production;
  anything in tests). Includes `save_feats` unfolding to the training layout
  ([M/2, 16, C], asr.py:236-250).
- audio IO is a plain generator of [chunk] float arrays (file or mic), not a
  thread+queue pair; live sources wrap their callback into a generator.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

SAMPLE_RATE = 16000


class FeatureRing:
    """Loop queue of per-20ms features + the 16-step/stride-2 attention
    window extractor (reference asr.py:100-112, 160-183)."""

    def __init__(self, audio_dim: int, context_size: int = 50,
                 buffer_count: int = 4, window: int = 16, att_frames: int = 8):
        self.audio_dim = audio_dim
        self.context_size = context_size
        self.size = buffer_count * context_size
        self.queue = np.zeros((self.size, audio_dim), np.float32)
        self.write_block = 0
        self.window = window
        # fake left padding: start the read window `window//2` behind zero
        self.front = self.size - window // 2
        self.tail = window // 2
        self.att_frames = att_frames
        self.att_feats: List[np.ndarray] = [
            np.zeros((window, audio_dim), np.float32)] * (att_frames // 2)

    def push_block(self, feats: np.ndarray) -> None:
        """feats: [T<=context_size, C] — one ASR step's trimmed logits."""
        start = self.write_block * self.context_size
        end = start + feats.shape[0]
        self.queue[start:end] = feats[: self.size - start]
        self.write_block = (self.write_block + 1) % (self.size
                                                     // self.context_size)

    def next_att_window(self) -> np.ndarray:
        """[att_frames, window, C] for the next rendered frame
        (the renderer consumes one per video frame)."""
        while len(self.att_feats) < self.att_frames:
            if self.front < self.tail:
                feat = self.queue[self.front:self.tail]
            else:
                feat = np.concatenate(
                    [self.queue[self.front:], self.queue[:self.tail]], axis=0)
            self.front = (self.front + 2) % self.size
            self.tail = (self.tail + 2) % self.size
            self.att_feats.append(feat.copy())
        out = np.stack(self.att_feats, axis=0)
        self.att_feats = self.att_feats[1:]
        return out


class StreamingASR:
    def __init__(
        self,
        audio_dim: int,
        feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        asr_model: str = "",
        fps: int = 50,
        left: int = 10,
        mid: int = 50,
        right: int = 10,
        save_feats: bool = False,
        device=None,
    ):
        self.audio_dim = audio_dim
        self.chunk = SAMPLE_RATE // fps        # 320 samples = 20 ms
        self.left, self.mid, self.right = left, mid, right
        self.frames: List[np.ndarray] = [
            np.zeros(self.chunk, np.float32)] * left
        self.terminated = False
        self.ring = FeatureRing(audio_dim, context_size=mid)
        self.save_feats = save_feats
        self.all_feats: List[np.ndarray] = []

        if feature_fn is not None:
            self.feature_fn = feature_fn
        else:
            self.feature_fn = self._build_ctc_fn(asr_model, device)

        # latency bookkeeping (asr.py:371-384)
        self.warm_up_steps = mid + right + 16 // 2 * 2 + 2 * 3

    def _build_ctc_fn(self, model_name: str, device=None):
        """The CTC model's logits function, on "cuda" unless `device`
        names another device."""
        try:
            import torch
            from transformers import AutoModelForCTC, AutoProcessor
        except ImportError as e:
            raise RuntimeError(f"transformers unavailable for ASR: {e}")
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        processor = AutoProcessor.from_pretrained(model_name)
        model = AutoModelForCTC.from_pretrained(model_name).to(dev).eval()

        def fn(samples: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                inputs = processor(samples, sampling_rate=SAMPLE_RATE,
                                   return_tensors="pt", padding=True)
                logits = model(inputs.input_values.to(dev)).logits[0]
            return logits.cpu().numpy()

        return fn

    def step(self, frame: Optional[np.ndarray]) -> bool:
        """Feed one 20 ms chunk (or None at end-of-stream). Returns True when
        the ring received new features (reference run_step, asr.py:185-233)."""
        if self.terminated:
            return False
        if frame is None:
            self.terminated = True
        else:
            self.frames.append(np.asarray(frame, np.float32))
            if len(self.frames) < self.left + self.mid + self.right:
                return False

        samples = np.concatenate(self.frames)
        if not self.terminated:
            self.frames = self.frames[-(self.left + self.right):]

        logits = self.feature_fn(samples)                   # [T, C]
        # stride trimming (asr.py:330-337)
        lo = max(0, self.left)
        hi = logits.shape[0] if self.terminated else (
            min(logits.shape[0], logits.shape[0] - self.right + 1))
        feats = logits[lo:hi]
        if self.save_feats:
            self.all_feats.append(feats)
        self.ring.push_block(feats)
        return True

    def run_stream(self, chunks: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Drive from a chunk generator; yields one [8, 16, C] attention
        window per video frame (one per 2 audio chunks: 50 fps audio chunks /
        25 fps video). The first window comes out after the warm-up latency
        of (mid + right) chunks, like the reference."""
        seen = 0
        for chunk in chunks:
            self.step(chunk)
            seen += 1
            if seen >= self.left + self.mid + self.right and seen % 2 == 0:
                yield self.ring.next_att_window()
        self.step(None)

    def feature_rows(self, chunks: Iterator[np.ndarray]
                     ) -> Iterator[np.ndarray]:
        """Per-video-frame feature rows in the TRAINING layout ([1, 16, C]
        windows of logit steps; unfold window 16 / stride 2 / pad 8 —
        reference asr.py:236-250) emitted INCREMENTALLY: row i covers logit
        steps [2i-8, 2i+8), so it is yielded as soon as step 2i+7 exists;
        end-of-stream rows flush with the offline zero right-pad.
        Concatenating every yield equals unfolded_features() exactly
        (tests/test_torch_serving_host.py) — the adapter that lets
        session.run_live consume a live microphone or wav."""
        if not self.save_feats:
            raise ValueError("feature_rows needs save_feats=True")
        pad = 16 // 2
        emitted = 0

        def new_rows(final: bool):
            nonlocal emitted
            if not self.all_feats:
                return
            feats = np.concatenate(self.all_feats, axis=0)      # [M, C]
            M = len(feats)
            total = M // 2 + 1 if final else max(0, (M - pad) // 2 + 1)
            if total <= emitted:
                return
            padded = np.pad(feats, ((pad, pad), (0, 0)))
            for r in range(emitted, total):
                yield padded[2 * r: 2 * r + 16][None]           # [1, 16, C]
            emitted = total

        for chunk in chunks:
            if self.step(chunk):
                yield from new_rows(False)
        self.step(None)
        yield from new_rows(True)

    def unfolded_features(self) -> np.ndarray:
        """All features in the training layout [M/2, 16, C] (--asr_save_feats,
        asr.py:236-250: unfold window 16, stride 2, pad 8)."""
        feats = np.concatenate(self.all_feats, axis=0)      # [M, C]
        M, C = feats.shape
        pad = 16 // 2
        padded = np.pad(feats, ((pad, pad), (0, 0)))
        starts = np.arange(0, M + 2 * pad - 16 + 1, 2)
        return np.stack([padded[s:s + 16] for s in starts], axis=0)


def wav_chunk_stream(path: str, fps: int = 50) -> Iterator[np.ndarray]:
    """File-mode chunk generator (reference create_file_stream,
    asr.py:252-266)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    if data.ndim > 1:
        data = data[:, 0]
    if sr != SAMPLE_RATE:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(sr), SAMPLE_RATE)
        data = resample_poly(data, SAMPLE_RATE // g, sr // g)
    chunk = SAMPLE_RATE // fps
    for i in range(0, len(data) - chunk + 1, chunk):
        yield np.asarray(data[i:i + chunk], np.float32)


def play_through(chunks: Iterator[np.ndarray],
                 fps: int = 50) -> Iterator[np.ndarray]:
    """Pass-through chunk wrapper that also plays each 20 ms chunk on the
    default speaker (reference --asr_play: a thread feeds a pyaudio output
    stream as chunks are consumed, asr.py:25-37,81-86). Dep-gated like the
    mic source: warns and degrades to a plain pass-through when no audio
    stack is installed (this build image ships none)."""
    stream = None

    def close(s):
        try:
            s.stop()
            s.close()
        except Exception:
            pass

    try:
        import sounddevice as sd

        stream = sd.OutputStream(samplerate=SAMPLE_RATE, channels=1,
                                 dtype="float32",
                                 blocksize=SAMPLE_RATE // fps)
        stream.start()
    except Exception as e:                       # ImportError / no device
        if stream is not None:                   # created but start() failed
            close(stream)
            stream = None
        print(f"[WARN] --asr_play: audio output unavailable ({e}); "
              "streaming silently")
    try:
        for chunk in chunks:
            if stream is not None:
                try:
                    stream.write(np.ascontiguousarray(chunk, np.float32)
                                 .reshape(-1, 1))
                except Exception:
                    close(stream)                # device vanished mid-run
                    stream = None
            yield chunk
    finally:
        if stream is not None:
            close(stream)


def mic_chunk_stream(fps: int = 50, device=None,
                     stop_event=None) -> Iterator[np.ndarray]:
    """Live-microphone chunk generator (reference create_pyaudio_stream,
    asr.py:268-310): 16 kHz mono float chunks of 1/fps seconds, produced
    until `stop_event` (a threading.Event) is set. Uses the sounddevice
    package when present, else pyaudio; raises with instructions when
    neither is installed (this build image ships no audio stack)."""
    chunk = SAMPLE_RATE // fps
    try:
        import queue as _queue

        import sounddevice as sd

        q: "_queue.Queue[np.ndarray]" = _queue.Queue()

        def cb(indata, frames, time_info, status):
            q.put(np.asarray(indata[:, 0], np.float32).copy())

        with sd.InputStream(samplerate=SAMPLE_RATE, channels=1,
                            blocksize=chunk, dtype="float32", device=device,
                            callback=cb):
            while stop_event is None or not stop_event.is_set():
                try:
                    yield q.get(timeout=0.5)
                except _queue.Empty:
                    continue
        return
    except ImportError:
        pass
    try:
        import pyaudio

        pa = pyaudio.PyAudio()
        stream = pa.open(format=pyaudio.paInt16, channels=1,
                         rate=SAMPLE_RATE, input=True,
                         frames_per_buffer=chunk,
                         input_device_index=device)
        try:
            while stop_event is None or not stop_event.is_set():
                raw = stream.read(chunk, exception_on_overflow=False)
                yield np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        finally:
            stream.stop_stream()
            stream.close()
            pa.terminate()
        return
    except ImportError:
        raise RuntimeError(
            "live-mic ASR needs the `sounddevice` or `pyaudio` package "
            "(neither ships in this image); use wav_chunk_stream for file "
            "input or install one of them") from None
