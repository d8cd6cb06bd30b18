"""The port's InferenceSession against the JAX session, and against itself.

Fixture: tests/test_serving.py's 64² toy identity with the two-blob
occupancy and a portrait-like narrow field of view (focal 4 x W), which
resolves the production plan (group 2, nb5w, prepass, bucket march). Its
restored JAX parameters, occupancy and geometry are written as the
workspace's production_state.pkl (no torso: a head-only identity), which
is what the port serves. Both sessions run on the same seeded features:

- rgb24 bytes within one level (the clipped image x 255, truncated: a
  pixel a float ulp either side of a level boundary may differ by one),
  yuv420p bytes within one level, the per-chunk counters equal and the
  same frame indices in the same order; the rebuild escapes fire at the
  same chunks in both;
- run_live is byte-equal to run() over irregular drips, after a second
  stream (no EMA leak) and across the buffer trim; frames are byte-equal
  across chunk sizes 3, 4 and 5 (tests/test_serving.py's live and chunk
  tests, held on the port);
- a head-only state serves over the dataset's background (the trained
  state's torso: tests/test_torch_serving_api.py);
- the plans of the fallback paths and a hash head serve; every plan the
  port has no path for raises, naming its ROADMAP item.

Stage-2 budget: infer_stage2_frac 1.0 at ray budgets in whole 1024-slot
steps, so the JAX session never truncates stage 2 (where the port's
stage-2 escape diverges from it)."""

import os
import pickle

import jax
import numpy as np
import pytest

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu.serving.streaming import NullSink as JNullSink
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.serving import InferenceSession
from lzzx_nerf_tpu_torch.serving.session import COUNTERS
from lzzx_nerf_tpu_torch.serving.streaming import NullSink, RawFileSink
from test_serving import _make_session_workspace
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

# the fixture's serving point: S 16 split 8, stage 2 never truncated
BASE = dict(asr_model="deepspeech", grid_size=32, max_steps=8,
            infer_samples=16, infer_stage_split=8, infer_stage2_frac=1.0)


def _quiet(msg):
    pass


def write_state(js, path, torso_leaves=None):
    """A production_state.pkl of the JAX session's restored identity."""
    st = {"head_ema": jax.tree.map(np.asarray, js.state.ema_params),
          "occ": {k: np.asarray(v) for k, v in js.occ._asdict().items()},
          "meta": {"res": js.ds.H, "grid": js.cfg.grid_size,
                   "audio_dim": int(js.ds.aud_features.shape[-1]),
                   "aabb": tuple(js.settings.aabb), "dt": js.settings.dt,
                   "intrinsics": js.ds.intrinsics,
                   "poses": np.asarray(js.ds.poses)}}
    if torso_leaves is not None:
        st["torso_leaves"] = torso_leaves
    with open(path, "wb") as f:
        pickle.dump(st, f)


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    root = tmp_path_factory.mktemp("blob")
    data, ws = _make_session_workspace(root, H=64, W=64, focal_mult=4.0,
                                       blob_occ=True)
    js = JSession(JConfig(**BASE))
    js.load_model(data, ws)
    write_state(js, os.path.join(ws, "production_state.pkl"))
    return data, ws


def _port(data, ws, **kw):
    s = InferenceSession(Config(**{**BASE, **kw}), device="cpu", log=_quiet)
    s.load_model(data, ws)
    return s


def _feats(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16, 29)).astype(np.float32)


class _YuvSink(NullSink):
    pix_fmt = "yuv420p"


class _JYuvSink(JNullSink):
    pix_fmt = "yuv420p"


def _record_jax(js, rec):
    """Record each JAX chunk's counters (frame n_active, chunk maxima of
    n_winmax, n_stage2, n_real, n_long) as the run loop fetches its
    program."""
    def get_render(fmt):
        render = JSession._get_render(js, fmt)

        def wrapped(*a):
            out = render(*a)
            bufs, acts, s2, _, wm, rl, lg, _ = out
            rec.append((np.asarray(acts), int(wm), int(s2), int(rl),
                        int(lg)))
            return out
        return wrapped
    js._get_render = get_render


def _record_port(ts, rec):
    check = ts._check_chunk

    def wrapped(base, count, cnt, plan):
        rec.append((base, cnt.copy()))
        check(base, count, cnt, plan)
    ts._check_chunk = wrapped


@pytest.mark.parametrize("plan", [
    # K2 from the Config, the bucket march engaged, a ray budget below the
    # frames' demand: the ray-budget and long-bucket escapes fire
    dict(infer_window_candidates=40, budget_frac=0.5),
    # K2 measured over the dataset's poses (no bucket split at K2 = S)
    dict(budget_frac=1.0),
], ids=["k2-override-bucket-escapes", "k2-measured"])
def test_session_matches_jax(blob, plan):
    data, ws = blob
    kw = {**BASE, **plan, "infer_chunk": 2}
    js = JSession(JConfig(**kw))
    js.load_model(data, ws)
    ts = _port(data, ws, **plan, infer_chunk=2)
    assert (ts.k2, ts.bucket, ts.budget, ts.stage2_budget) == (
        js.k2, js._bucket, js.budget, js.stage2_budget)
    if "infer_window_candidates" in plan:
        assert ts.bucket is not None and ts.bucket[0] >= 16
    feats = _feats(5, 3)
    for fmt, jsink, tsink in (("rgb24", JNullSink, NullSink),
                              ("yuv420p", _JYuvSink, _YuvSink)):
        jrec, trec, jf, tf = [], [], [], []
        _record_jax(js, jrec)
        _record_port(ts, trec)
        for s in (js, ts):
            s.set_audio_features(feats)
        js.run(jsink(), on_frame=lambda i, b: jf.append((i, np.asarray(b))))
        ts.run(tsink(), on_frame=lambda i, b: tf.append((i, b)))
        assert [i for i, _ in tf] == [i for i, _ in jf] == list(range(5))
        for (_, a), (_, b) in zip(tf, jf):
            assert a.shape == b.shape and a.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, fmt
        assert len(trec) == len(jrec) == 3
        for (base, cnt), (acts, wm, s2, rl, lg) in zip(trec, jrec):
            c = dict(zip(COUNTERS, cnt.T))
            assert list(c["n_active"]) == list(acts[:len(cnt)])
            assert (c["n_winmax"].max(), c["n_stage2"].max(),
                    c["n_real"].max(), c["n_long"].max()) == (wm, s2, rl, lg)
        assert (ts.budget, ts.long_budget, ts.k2) == (
            js.budget, js.long_budget, js.k2)
    if plan.get("budget_frac") == 0.5:
        assert ts.rebuilds >= 1


@pytest.fixture(scope="module")
def blob_full(blob):
    """Sessions at the whole-frame ray budget: no escape can fire, so the
    frames do not depend on where chunks start."""
    data, ws = blob
    return lambda chunk: _port(data, ws, infer_window_candidates=40,
                               budget_frac=1.0, infer_chunk=chunk)


def _run(s, feats):
    got = {}
    s.set_audio_features(feats)
    s.run(on_frame=lambda i, b: got.__setitem__(i, b))
    return got


def test_run_live_matches_run(blob_full):
    """tests/test_serving.py::test_run_live_matches_offline on the port."""
    s, s2 = blob_full(3), blob_full(3)
    feats = _feats(9, 11)
    offline = _run(s, feats)
    live = {}

    def drips():
        at = 0
        for k in (1, 4, 0, 2, 2):
            yield feats[at:at + k]
            at += k

    n_live, _ = s2.run_live(drips(),
                            on_frame=lambda i, b: live.__setitem__(i, b))
    assert n_live == 9
    assert list(live) == sorted(offline) == list(range(9))
    for i in range(9):
        np.testing.assert_array_equal(live[i], offline[i])

    # a second live stream is a fresh utterance: no EMA carried over
    feats2 = _feats(4, 12)
    offline2 = _run(s, feats2)
    live2 = {}
    s2.run_live(iter([feats2[:1], feats2[1:]]),
                on_frame=lambda i, b: live2.__setitem__(i, b))
    for i in range(4):
        np.testing.assert_array_equal(live2[i], offline2[i])

    # the buffer trim (aud_offset bookkeeping) at a toy stride
    feats3 = _feats(16, 13)
    offline3 = _run(s, feats3)
    s2._live_trim_stride = 3
    live3 = {}
    s2.run_live((feats3[i:i + 2] for i in range(0, 16, 2)),
                on_frame=lambda i, b: live3.__setitem__(i, b))
    assert s2.ds.aud_offset == 0
    assert len(s2.ds.aud_features) < 16
    for i in range(16):
        np.testing.assert_array_equal(live3[i], offline3[i])


def test_frames_invariant_to_chunk_size(blob_full):
    """tests/test_serving.py::test_session_frames_invariant_to_chunk_size
    on the port: padded tail slots do not advance the smooth-lips EMA."""
    feats = _feats(6, 5)

    def frames(chunk):
        s = blob_full(chunk)
        first = _run(s, feats)
        return first, _run(s, feats)

    base_a, base_b = frames(3)
    for chunk in (4, 5):
        got_a, got_b = frames(chunk)
        assert sorted(got_a) == list(range(6))
        for i in range(6):
            np.testing.assert_array_equal(got_a[i], base_a[i])
            np.testing.assert_array_equal(got_b[i], base_b[i])


def test_sink_gets_frames_in_order_and_is_closed_on_failure(blob_full,
                                                           tmp_path):
    s = blob_full(2)
    feats = _feats(5, 7)
    s.set_audio_features(feats)
    got = {}
    sink = RawFileSink(str(tmp_path / "a.raw"))
    n, _ = s.run(sink, on_frame=lambda i, b: got.__setitem__(i, b))
    assert n == 5 and sink._f is None
    assert (tmp_path / "a.raw").read_bytes() == b"".join(
        got[i].tobytes() for i in range(5))

    class Broken(RawFileSink):
        def push(self, b):
            if self.count == 3:
                raise BrokenPipeError("encoder died")
            super().push(b)

    bad = Broken(str(tmp_path / "b.raw"))
    s.set_audio_features(feats)
    with pytest.raises(BrokenPipeError):
        s.run(bad)
    assert bad._f is None and bad.count == 3


def test_head_only_serves_over_dataset_background(blob):
    """No torso in the state: the head composites over the dataset's
    bc.jpg (the JAX session's background without a torso workspace)."""
    data, ws = blob
    frames, plates = {}, {}
    for bg in ("", "black", "white"):
        s = _port(data, ws, infer_window_candidates=40, budget_frac=1.0,
                  bg_img=bg)
        assert s.torso is None
        frames[bg] = _run(s, _feats(1, 9))[0].reshape(64, 64, 3)
        plates[bg] = s.ds.bg_img
    ds_bg = plates[""]
    assert 0.7 < ds_bg.mean() < 0.9      # the fixture's grey bc.jpg
    # a pixel is img + (1 - wsum) x background: the black and white
    # frames give (1 - wsum), and the bc.jpg frame must follow the plate
    # (each frame truncated to a level: 3 levels in all)
    fb, fw, fc = (frames[k].astype(np.float64) for k in ("black", "white",
                                                          ""))
    vis = (fw - fb) / 255.0
    assert vis.mean() > 0.05
    assert np.abs(fc - (fb + vis * ds_bg * 255.0)).max() <= 3.0
    assert np.abs(fc - fw).mean() > 5.0


@pytest.fixture(scope="module")
def blob_hash(blob, tmp_path_factory):
    """The blob identity with a hash head: its production state with the
    dense tables replaced by seeded hash tables (encoder_xy, encoder_yz,
    encoder_xz of triplane_spec(1))."""
    from lzzx_nerf_tpu_torch.models.nerf import triplane_spec

    data, ws = blob
    with open(os.path.join(ws, "production_state.pkl"), "rb") as f:
        st = pickle.load(f)
    head = {k: v for k, v in st["head_ema"].items()
            if not k.startswith("encoder_")}
    rng = np.random.default_rng(8)
    rows = triplane_spec(1.0).total_params
    for p in ("xy", "yz", "xz"):
        head[f"encoder_{p}"] = rng.uniform(-0.5, 0.5, (rows, 1)).astype(
            np.float32)
    st["head_ema"] = head
    hws = tmp_path_factory.mktemp("blob_hash")
    with open(hws / "production_state.pkl", "wb") as f:
        pickle.dump(st, f)
    return str(hws)


@pytest.mark.parametrize("kw,path,group", [
    (dict(bound=2.0), "full", 1),
    (dict(infer_block=1), "compact", 1),
    (dict(infer_march_group=1), "blocks", 1),
    (dict(infer_stage_split=0), "blocks", 2),
    (dict(train_camera=True), "blocks", 2),
    (dict(encoder="hash"), "blocks", 2),
])
def test_ported_plans_serve(blob, blob_hash, kw, path, group):
    """The plans a session refused before their paths were ported:
    cascade 2 (render_rays), per-ray windows (render_rays_compact), the
    group-1 march, the single-pass composite, train_camera (a state
    without camera parameters serves unrefined, as in the JAX session),
    and the hash head (a state holding the hash tables; its parity with
    the JAX session is tests/test_torch_hash.py)."""
    data, ws = blob
    if kw.get("encoder") == "hash":
        ws = blob_hash
    s = _port(data, ws, infer_window_candidates=40, budget_frac=1.0, **kw)
    assert (s.path, s.march_group) == (path, group)
    assert s.field.encoder == kw.get("encoder", "dense")
    assert s.settings.cascade == (2 if "bound" in kw else 1)
    got = _run(s, _feats(2, 4))
    assert sorted(got) == [0, 1]
    assert all(b.shape == (64 * 64 * 3,) for b in got.values())


@pytest.mark.parametrize("kw,item", [
    (dict(infer_march_group=3), "item 8"),
    (dict(infer_sample_frac=0.5), "item 8"),
    (dict(infer_data_parallel=2), "item 7"),
    (dict(infer_march_variant="quadw"), "item 8"),
    (dict(infer_march_prepass=False), "item 8"),
    (dict(infer_table_bf16=False), "item 8"),
    (dict(emb=True), "item 8"),
    (dict(exp_eye=False), "item 8"),
])
def test_unported_plans_raise(blob, kw, item):
    data, ws = blob
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        _port(data, ws, **kw)


def test_load_model_refusals(blob, tmp_path):
    data, ws = blob
    with pytest.raises(ValueError, match="grid"):
        _port(data, ws, grid_size=64)
    with pytest.raises(ValueError, match="dense head, the Config encoder"):
        _port(data, ws, encoder="hash")
    with pytest.raises(FileNotFoundError, match="production_state.pkl"):
        _port(data, str(tmp_path))
    s = InferenceSession(Config(**BASE), device="cpu", log=_quiet)
    with pytest.raises(RuntimeError, match="load_model first"):
        s.set_audio_features(_feats(2, 0))
    # a wide field of view at 40² exceeds the block march's drift
    # envelope: the session steps down to the per-ray march; an odd frame
    # takes the per-ray compact render (both once refused here)
    from conftest import make_toy_dataset

    wide = make_toy_dataset(tmp_path / "wide", H=40, W=40, focal_mult=1.5)
    assert _port(wide, ws).march_plan == (1, "nb5w", False)
    odd = make_toy_dataset(tmp_path / "odd", H=41, W=40, focal_mult=4.0)
    assert _port(odd, ws).path == "compact"


def test_eye_follows_fix_eye_and_mirror_index(blob):
    """Eyes come from au.csv through mirror_index, or fix_eye for all."""
    data, ws = blob
    s = _port(data, ws, infer_window_candidates=40, budget_frac=1.0)
    seen = []
    orig = s._stream

    def spy(start, n, frame_inputs, *a, **k):
        seen.extend(frame_inputs(i) for i in range(start, n))
        return orig(start, n, frame_inputs, *a, **k)

    s._stream = spy
    s.set_audio_features(_feats(8, 1))
    s.run(max_frames=8)
    n = s.ds.num_frames
    assert [p for p, _, _ in seen] == [s.ds.mirror_index(i) for i in range(8)]
    assert [e for _, e, _ in seen] == [s.ds.eye_area[s.ds.mirror_index(i)]
                                       for i in range(8)]
    assert seen[n][0] == n - 1   # the ping-pong turn
    seen.clear()
    s.cfg = s.cfg.replace(fix_eye=0.3)
    s.run(max_frames=2)
    assert [e for _, e, _ in seen] == [0.3, 0.3]
