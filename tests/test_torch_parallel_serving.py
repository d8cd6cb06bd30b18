"""The port's frame-parallel serving (InferenceSession with
infer_data_parallel; the JAX session's make_render_dp) on the CPU, over
tests/test_torch_serving.py's 64² two-blob identity: two replicas on the
CPU (the session's devices= seam) with infer_chunk 3, which rounds the
chunk to 4; run() and run_live stream frames byte-equal to the serial
session's, and within one level of the JAX session's infer_data_parallel
frames (the port and JAX agree to one level in rgb24,
tests/test_torch_serving.py); on one device infer_data_parallel 2 serves
serially, as in JAX.
"""

import numpy as np
import pytest

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.serving import InferenceSession
from test_torch_serving import BASE, _feats, _quiet, blob  # noqa: F401
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

PLAN = dict(infer_window_candidates=40, budget_frac=1.0, infer_chunk=3)


def _session(data, ws, devices=None, **kw):
    s = InferenceSession(Config(**{**BASE, **PLAN, **kw}), device="cpu",
                         log=_quiet, devices=devices)
    s.load_model(data, ws)
    return s


def _frames(s, feats, live=False):
    got = {}
    if live:
        def drips():
            at = 0
            for k in (1, 4, 0, 2, 2, 3):
                yield feats[at:at + k]
                at += k
        s.run_live(drips(), on_frame=lambda i, b: got.__setitem__(i, b))
    else:
        s.set_audio_features(feats)
        s.run(on_frame=lambda i, b: got.__setitem__(i, b))
    return got


@pytest.fixture(scope="module")
def serial_frames(blob):
    data, ws = blob
    s = _session(data, ws)
    feats = _feats(12, 21)
    return feats, _frames(s, feats), _frames(s, feats, live=True)


@pytest.mark.parametrize("live", [False, True], ids=["run", "run_live"])
def test_frame_parallel_matches_serial(blob, serial_frames, live):
    """Two replicas (both on the CPU, the devices= seam) stream the serial
    session's bytes through run() and run_live; the chunk rounds up to 4;
    each replica renders its half of every chunk from its own copy."""
    data, ws = blob
    feats, offline, streamed = serial_frames
    s = _session(data, ws, devices=["cpu", "cpu"], infer_data_parallel=2)
    assert s.chunk == 4 and len(s._replicas) == 2
    assert all(r.field is not s.field and r.device.type == "cpu"
               for r in s._replicas)
    got = _frames(s, feats, live=live)
    want = streamed if live else offline
    assert sorted(got) == sorted(want) == list(range(12))
    for i in range(12):
        np.testing.assert_array_equal(got[i], want[i])


def test_frame_parallel_matches_jax(blob, serial_frames):
    """The JAX session's frame-parallel program (infer_data_parallel 2 on
    two of the 8 virtual devices) and the port's over two replicas: the
    same frames within one level."""
    data, ws = blob
    feats, offline, _ = serial_frames
    js = JSession(JConfig(**{**BASE, **PLAN, "infer_data_parallel": 2}))
    js.load_model(data, ws)
    assert js._chunk_size() == 4
    jf = {}
    js.set_audio_features(feats)
    js.run(on_frame=lambda i, b: jf.__setitem__(i, np.asarray(b)))
    s = _session(data, ws, devices=["cpu", "cpu"], infer_data_parallel=2)
    got = _frames(s, feats)
    assert sorted(jf) == sorted(got) == list(range(12))
    for i in range(12):
        assert np.abs(got[i].astype(int) - jf[i].astype(int)).max() <= 1
        np.testing.assert_array_equal(got[i], offline[i])


def test_infer_data_parallel_on_one_device_serves_serially(blob,
                                                           serial_frames):
    """On one device (the CPU) infer_data_parallel 2 clamps to one and
    serves the serial program, as the JAX session does."""
    data, ws = blob
    feats, offline, _ = serial_frames
    logs = []
    s = InferenceSession(Config(**{**BASE, **PLAN,
                                   "infer_data_parallel": 2}),
                         device="cpu", log=logs.append)
    s.load_model(data, ws)
    assert s._replicas == [] and s.chunk == 3
    assert any("serving serially" in m for m in logs)
    got = _frames(s, feats)
    for i in range(12):
        np.testing.assert_array_equal(got[i], offline[i])
