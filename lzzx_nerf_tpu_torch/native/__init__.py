"""Native (C++) host components, loaded with ctypes: the frame pump that
feeds rendered frames to the encoder without stalling the render loop
(framepump.py). Built on first use with g++; the sinks write from Python
where it cannot be built."""

from .framepump import FramePump, native_available  # noqa: F401
