"""The serving stack: the sessions (the port bench's ServingSession and the
JAX session's InferenceSession), frame sinks, the streaming ASR feature
pipeline and the HTTP API (webapi.py)."""

from .session import InferenceSession, ServingSession
from .state_io import load_trained_state, params_from_jax, params_to_jax
from .streaming import (FfmpegMp4Sink, FfmpegRtmpSink, FrameSink, NullSink,
                        RawFileSink, make_sink)

__all__ = ["FfmpegMp4Sink", "FfmpegRtmpSink", "FrameSink",
           "InferenceSession", "NullSink", "RawFileSink", "ServingSession",
           "load_trained_state", "make_sink", "params_from_jax",
           "params_to_jax"]
