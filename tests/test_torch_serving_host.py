"""The port's host-side serving modules against the JAX package's on the
same seeded inputs: the config, the dataset provider (tests/test_provider.py's
fixture and variants of it), pose and audio-window helpers, the streaming
ASR feature ring, the mel front-end, the sink commands; and, on the port
alone, the frame pump (including its build from several processes into
one empty directory at once), the head-only trained state, and that
every module of the port imports with JAX made unimportable."""

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from lzzx_nerf_tpu import config as jconfig
from lzzx_nerf_tpu.audio import mel as jmel
from lzzx_nerf_tpu.data import provider as jprov
from lzzx_nerf_tpu.serving import asr as jasr
from lzzx_nerf_tpu.serving import streaming as jstream
from lzzx_nerf_tpu.utils import audio as jaudio
from lzzx_nerf_tpu.utils import pose as jpose
from lzzx_nerf_tpu_torch import config as tconfig
from lzzx_nerf_tpu_torch.audio import hubert as thubert
from lzzx_nerf_tpu_torch.audio import mel as tmel
from lzzx_nerf_tpu_torch.data import provider as tprov
from lzzx_nerf_tpu_torch.native import framepump
from lzzx_nerf_tpu_torch.serving import asr as tasr
from lzzx_nerf_tpu_torch.serving import streaming as tstream
from lzzx_nerf_tpu_torch.serving.state_io import (TORSO_LEAF_PATHS,
                                                  load_trained_state)
from lzzx_nerf_tpu_torch.utils import audio as taudio
from lzzx_nerf_tpu_torch.utils import pose as tpose
from lzzx_nerf_tpu_torch.utils.profiling import PhaseAccumulator
from test_provider import N_FRAMES, dataset_dir  # noqa: F401  (fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATE = os.path.join(REPO, "trained", "production_state.pkl")


def test_config_matches_jax():
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(
        jconfig.Config())
    for kw in ({}, {"asr_model": "deepspeech", "bound": 2.0},
               {"asr_model": "esperanto", "offset": (0.1, 0.2, 0.3)}):
        t, j = tconfig.Config(**kw), jconfig.Config(**kw)
        assert (t.audio_in_dim, t.cascade, t.aabb()) == (
            j.audio_in_dim, j.cascade, j.aabb())
        assert t.to_json() == j.to_json()
        assert tconfig.Config.from_json(t.to_json()) == t


# ---- the provider ----------------------------------------------------------

def _variant(root, name, tmp_path):
    """The fixture dataset, rewritten for one case -> (path, Config kw,
    NeRFDataset kw)."""
    if name in ("focal_len", "smooth", "white", "black", "downscale", "val",
                "offset"):
        kw = {"smooth": dict(smooth_path=True, smooth_path_window=3,
                             smooth_eye=True),
              "white": dict(bg_img="white"), "black": dict(bg_img="black"),
              "offset": dict(scale=2.0, offset=(0.1, -0.2, 0.05))}
        return root, kw.get(name, {}), (
            {"downscale": 2} if name == "downscale" else
            {"type": "val"} if name == "val" else {})
    d = tmp_path / name
    shutil.copytree(root, d)
    with open(d / "transforms_train.json") as f:
        tf = json.load(f)
    cfg = {}
    if name == "fl_xy":
        tf.pop("focal_len")
        tf.pop("cx")
        tf["fl_x"], tf["fl_y"] = 61.5, 58.25
    elif name == "camera_angle":
        tf.pop("focal_len")
        tf.pop("h")
        tf.pop("w")
        tf["camera_angle_x"] = 0.7
    elif name == "bg_resized":
        import cv2

        cv2.imwrite(str(d / "bc.jpg"), np.random.default_rng(4).integers(
            0, 255, (57, 33, 3), dtype=np.uint8))
    elif name == "no_au":
        os.remove(d / "au.csv")
    elif name == "novel":
        np.save(d / "novel.npy", np.random.default_rng(5).standard_normal(
            (11, 16, 29)).astype(np.float32))
        cfg = dict(aud=str(d / "novel.npy"))
    elif name == "aud_id":
        for i, fr in enumerate(tf["frames"]):
            fr["aud_id"] = (i * 3 + 1) % (N_FRAMES + 2)
    with open(d / "transforms_train.json", "w") as f:
        json.dump(tf, f)
    return str(d), cfg, {}


@pytest.mark.parametrize("name", [
    "focal_len", "fl_xy", "camera_angle", "smooth", "white", "black",
    "bg_resized", "downscale", "val", "no_au", "novel", "aud_id",
    "offset"])
def test_provider_matches_jax(dataset_dir, tmp_path, name):  # noqa: F811
    path, cfg_kw, ds_kw = _variant(dataset_dir, name, tmp_path)
    kw = dict(path=path, asr_model="deepspeech", exp_eye=True, **cfg_kw)
    j = jprov.NeRFDataset(jconfig.Config(**kw), **ds_kw)
    t = tprov.NeRFDataset(tconfig.Config(**kw), **ds_kw)
    for ds in (j, t):
        ds.training = False
    assert (t.H, t.W, t.num_frames, len(t)) == (j.H, j.W, j.num_frames,
                                                len(j))
    assert t.intrinsics == j.intrinsics
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_array_equal(t.eye_area, j.eye_area)
    np.testing.assert_array_equal(t.bg_img, j.bg_img)
    np.testing.assert_array_equal(t.aud_features, j.aud_features)
    assert t.aud_ids == j.aud_ids and t.face_rect == j.face_rect
    n = len(t.aud_features)
    assert [t.mirror_index(i) for i in range(3 * t.num_frames)] == [
        j.mirror_index(i) for i in range(3 * j.num_frames)]
    for off in (0, 3):
        t.aud_offset = j.aud_offset = off
        for i in range(off - 2, off + n + 5):
            np.testing.assert_array_equal(t.audio_window(i),
                                          j.audio_window(i))
    t.aud_offset = j.aud_offset = 0
    if name in ("focal_len", "smooth", "downscale"):
        for i in (0, 2):
            bt, bj = t.frame(i), j.frame(i)
            assert bt.keys() == bj.keys()
            for k in bt:
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


def test_pose_and_window_helpers_match_jax():
    rng = np.random.default_rng(0)
    poses = []
    for _ in range(9):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = q
        p[:3, 3] = rng.standard_normal(3)
        poses.append(p)
    for p in poses:
        for scale, off in ((4.0, (0, 0, 0)), (2.5, (0.1, -0.3, 0.2))):
            np.testing.assert_array_equal(
                tpose.nerf_matrix_to_ngp(p, scale, off),
                jpose.nerf_matrix_to_ngp(p, scale, off))
    P = np.stack(poses)
    for k in (1, 3, 7, 14):
        np.testing.assert_array_equal(tpose.smooth_camera_path(P, k),
                                      jpose.smooth_camera_path(P, k))
    feats = rng.standard_normal((5, 16, 4)).astype(np.float32)
    for att in (0, 1, 2):
        for i in range(-1, 9):
            np.testing.assert_array_equal(
                taudio.get_audio_features_np(feats, att, i),
                jaudio.get_audio_features_np(feats, att, i))


# ---- ASR, mel, sinks -------------------------------------------------------

def _chunk_value_fn(C):
    def fn(samples):
        T = len(samples) // 320
        rows = samples[:T * 320].reshape(T, 320).mean(-1)
        return np.repeat(rows[:, None], C, axis=1).astype(np.float32)
    return fn


def test_feature_ring_and_streaming_asr_match_jax():
    C = 8
    rng = np.random.default_rng(1)
    rings = [mod.FeatureRing(audio_dim=C, context_size=50)
             for mod in (tasr, jasr)]
    for _ in range(5):
        block = rng.standard_normal((50, C)).astype(np.float32)
        for r in rings:
            r.push_block(block)
        for _ in range(20):
            np.testing.assert_array_equal(rings[0].next_att_window(),
                                          rings[1].next_att_window())

    def chunks():
        return (np.full(320, i, np.float32) for i in range(137))

    out = []
    for mod in (tasr, jasr):
        a = mod.StreamingASR(audio_dim=C, feature_fn=_chunk_value_fn(C))
        windows = list(a.run_stream(chunks()))
        b = mod.StreamingASR(audio_dim=C, feature_fn=_chunk_value_fn(C),
                             save_feats=True)
        rows = list(b.feature_rows(chunks()))
        out.append((windows, rows, b.unfolded_features()))
    (tw, tr, tu), (jw, jr, ju) = out
    assert len(tw) == len(jw) > 0 and len(tr) == len(jr) > 0
    for a, b in zip(tw + tr, jw + jr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(np.concatenate(tr), tu)
    with pytest.raises(ValueError, match="save_feats"):
        next(tasr.StreamingASR(audio_dim=C, feature_fn=_chunk_value_fn(C))
             .feature_rows(chunks()))


def test_wav_chunks_and_mel_match_jax(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(2)
    t = np.arange(int(1.3 * 16000)) / 16000
    wav = (np.sin(2 * np.pi * 300 * t) + 0.1 * rng.standard_normal(len(t))
           ).astype(np.float32)
    np.testing.assert_array_equal(tmel.melspectrogram(wav),
                                  jmel.melspectrogram(wav))
    np.testing.assert_array_equal(tmel.mel_filterbank(tmel.MelParams()),
                                  jmel.mel_filterbank(jmel.MelParams()))
    for sr in (16000, 22050):
        tc = tmel.wav_to_mel_chunks(wav, sr)
        jc = jmel.wav_to_mel_chunks(wav, sr)
        assert len(tc) == len(jc)
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)
    short = wav[:800]
    assert [c.shape for c in tmel.wav_to_mel_chunks(short)] == [
        c.shape for c in jmel.wav_to_mel_chunks(short)]
    for sr in (16000, 8000):
        path = str(tmp_path / f"a{sr}.wav")
        wavfile.write(path, sr, (wav[:sr] * 20000).astype(np.int16))
        tc = list(tasr.wav_chunk_stream(path))
        jc = list(jasr.wav_chunk_stream(path))
        assert len(tc) == len(jc) > 0
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)


def test_audio_io_gates(monkeypatch):
    """No speaker: play_through passes chunks through in order; no mic
    backend: mic_chunk_stream raises; no transformers: the HuBERT
    extractor and the CTC model raise with a clear message."""
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    chunks = [np.full(320, i, np.float32) for i in range(5)]
    out = list(tasr.play_through(iter(chunks)))
    assert all(np.array_equal(a, b) for a, b in zip(out, chunks))
    with pytest.raises(RuntimeError, match="sounddevice"):
        next(tasr.mic_chunk_stream())
    with pytest.raises(RuntimeError, match="transformers"):
        thubert.HubertFeatureExtractor()
    with pytest.raises(RuntimeError, match="transformers"):
        tasr.StreamingASR(audio_dim=8, asr_model="any")


def test_audio_models_run_on_the_card_unless_asked(monkeypatch):
    """HuBERT and the CTC model default to "cuda" (raising without a
    GPU, never falling back to the CPU), take the device they are given,
    and the server builds its extractor on its session's device."""
    import types

    import torch

    from lzzx_nerf_tpu_torch.serving.webapi import ServerState

    class Model:
        def to(self, dev):
            self.dev = torch.device(dev)
            return self

        def eval(self):
            return self

    class Loader:
        @staticmethod
        def from_pretrained(path):
            return Model()

    fake = types.ModuleType("transformers")
    for name in ("HubertModel", "Wav2Vec2Processor", "AutoModelForCTC",
                 "AutoProcessor"):
        setattr(fake, name, Loader)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thubert.HubertFeatureExtractor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tasr.StreamingASR(audio_dim=8, asr_model="any")
    h = thubert.HubertFeatureExtractor(device="cpu")
    assert h.device == h.model.dev == torch.device("cpu")
    tasr.StreamingASR(audio_dim=8, asr_model="any", device="cpu")
    state = ServerState(tconfig.Config(), device="cpu")
    assert state._get_hubert().model.dev == state.session.device


def test_hubert_streamer_matches_jax():
    from lzzx_nerf_tpu.audio.hubert import HubertStreamer as JStreamer

    class FakeHubert:
        def features(self, data):
            k = max(0, (len(data) - 80) // 640)
            return np.asarray(data[:k * 640],
                              np.float32).reshape(k, 640)[:, ::40]

    pcm = np.random.default_rng(17).standard_normal(
        3 * 16000 + 321).astype(np.float32)
    parts = np.split(pcm, [1000, 9000, 16100, 16500, 40000])
    t = list(thubert.HubertStreamer(FakeHubert()).feature_stream(parts))
    j = list(JStreamer(FakeHubert()).feature_stream(parts))
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def _commands(mod, tmp_path):
    model_dir = tmp_path / "model"
    model_dir.mkdir(parents=True, exist_ok=True)
    with open(model_dir / "video_crop_parameter.json", "w") as f:
        json.dump({"x": 12, "y": 34}, f)
    (model_dir / "readySourceVideo.mp4").write_bytes(b"")
    out = {}
    hls = mod.FfmpegHlsSink(str(tmp_path / "hls"), 64, 48,
                            segment_type="fmp4", audio_path="a.wav")
    out["hls"] = hls._stdin_args() + hls._output_args()
    ts = mod.FfmpegHlsSink(str(tmp_path / "hls2"), 64, 48)
    out["hls_ts"] = ts._stdin_args() + ts._output_args()
    mp4 = mod.FfmpegMp4Sink("o.mp4", 64, 48, audio_path="a.wav")
    out["mp4"] = mp4._stdin_args() + mp4._output_args()
    rtmp = mod.FfmpegRtmpSink("rtmp://h/live", 64, 48, local_mp4="l.mp4")
    out["rtmp"] = rtmp._stdin_args() + rtmp._output_args()
    for kind in ("rtmp", "mp4"):
        s = mod.make_sink(kind, 64, 48, path="o.mp4",
                          rtmp_url="rtmp://h/live",
                          model_dir=str(model_dir), audio_path="a.wav")
        out[f"overlay_{kind}"] = (type(s).__name__, s.command())
    for kind in ("raw", "null", "hls", "hls-fmp4"):
        out[kind] = type(mod.make_sink(kind, 4, 4, path=str(
            tmp_path / f"{kind}.out"))).__name__
    assert hls.frame_bytes == 64 * 48 * 3 // 2
    return out


def test_sink_commands_match_jax(tmp_path):
    t = _commands(tstream, tmp_path / "t")
    j = _commands(jstream, tmp_path / "j")
    assert t.keys() == j.keys()
    for k in t:
        assert json.dumps(t[k]).replace(str(tmp_path / "t"), "") == \
            json.dumps(j[k]).replace(str(tmp_path / "j"), ""), k


def test_raw_filtered_and_gated_sinks(tmp_path, monkeypatch):
    p = str(tmp_path / "out.raw")
    sink = tstream.RawFileSink(p)
    frame = np.arange(48, dtype=np.uint8).tobytes()
    for _ in range(3):
        sink.push(frame)
    sink.close()
    assert open(p, "rb").read() == frame * 3 and sink.count == 3

    class MemSink(tstream.RawFileSink):
        width, height = 4, 2

    inner = MemSink(str(tmp_path / "f.raw"))
    f = tstream.FilteredSink(inner, lambda a: 255 - a)
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    f.push(img.tobytes())
    f.close()
    got = np.frombuffer((tmp_path / "f.raw").read_bytes(), np.uint8)
    np.testing.assert_array_equal(got.reshape(2, 4, 3), 255 - img)
    with pytest.raises(ValueError, match="rgb24"):
        tstream.FilteredSink(tstream.FfmpegMp4Sink("x.mp4", 4, 2),
                             lambda a: a)
    monkeypatch.setitem(sys.modules, "gfpgan", None)
    with pytest.raises(RuntimeError, match="gfpgan"):
        tstream.load_face_restorer()
    monkeypatch.setattr(tstream.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tstream.FfmpegMp4Sink("x.mp4", 4, 2).push(b"\0" * 12)


def test_phase_accumulator():
    acc = PhaseAccumulator()
    for _ in range(3):
        with acc.phase("a"):
            pass
    with pytest.raises(KeyError):
        with acc.phase("b"):
            raise KeyError("x")
    assert set(acc.totals) == {"a", "b"}
    assert acc.report().startswith("a=") and "b=" in acc.report()


# ---- the frame pump --------------------------------------------------------

FRAME = 64 * 64 * 3


def test_pump_writes_in_order_and_reports_errors(tmp_path):
    if not framepump.native_available():
        pytest.fail(f"the frame pump did not build: {framepump._lib_err}")
    path = tmp_path / "frames.raw"
    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT, 0o644)
    pump = framepump.FramePump(fd, FRAME, capacity=4)
    frames = [bytes([i]) * FRAME for i in range(20)]
    for fr in frames:
        pump.push(fr)
    with pytest.raises(ValueError, match="frame must be"):
        pump.push(b"short")
    assert pump.close() == 20
    os.close(fd)
    assert path.read_bytes() == b"".join(frames)
    with pytest.raises(ValueError, match="after close"):
        pump.push(frames[0])
    r, w = os.pipe()
    os.close(r)
    pump = framepump.FramePump(w, FRAME, capacity=2)
    with pytest.raises(BrokenPipeError):
        for fr in frames:
            pump.push(fr)
        pump.close()
    os.close(w)


def test_pump_builds_from_many_processes_at_once(tmp_path):
    """Eight processes build the pump into one empty directory at the same
    moment (the race that cost the JAX copy its tests under xdist): each
    writes its own temporary file and renames it into place, so every
    process loads the library and writes through it, and no temporary
    file is left behind."""
    build = tmp_path / "build"
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {REPO!r})
        from lzzx_nerf_tpu_torch.native.framepump import load_library
        while not os.path.exists({str(go)!r}):
            time.sleep(0.005)
        lib = load_library({str(build)!r})
        out = sys.argv[1]
        fd = os.open(out, os.O_WRONLY | os.O_CREAT, 0o644)
        h = lib.fp_create(fd, 4, 2)
        assert lib.fp_push(h, b"abcd") == 0
        assert lib.fp_close(h) == 1
        os.close(fd)
        print("OK")
    """)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / f"o{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}) for i in range(8)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in out, err[-2000:]
        assert "FileNotFoundError" not in err
    assert all((tmp_path / f"o{i}").read_bytes() == b"abcd"
               for i in range(8))
    built = os.listdir(build)
    assert len(built) == 1 and built[0].startswith("libframepump-"), built


# ---- the trained state and the package -------------------------------------

def test_state_without_torso_loads_head_only(tmp_path):
    with open(STATE, "rb") as f:
        raw = pickle.load(f)
    full = load_trained_state(STATE)
    assert set(full) == {"head", "torso", "occ", "meta"}
    assert full["torso"] is not None and set(full["torso"]) >= {
        "anchor_points", "individual_codes_torso", "torso_net"}
    raw.pop("torso_leaves")
    p = tmp_path / "head.pkl"
    with open(p, "wb") as f:
        pickle.dump(raw, f)
    head = load_trained_state(str(p))
    assert head["torso"] is None
    np.testing.assert_array_equal(head["occ"]["occ"], full["occ"]["occ"])
    raw["torso_leaves"] = [np.zeros(1)] * (len(TORSO_LEAF_PATHS) - 1)
    with open(p, "wb") as f:
        pickle.dump(raw, f)
    with pytest.raises(ValueError, match="torso leaves"):
        load_trained_state(str(p))


def test_every_port_module_imports_without_jax():
    """A fresh interpreter with jax, jaxlib and the JAX package made
    unimportable imports every module of the port; none of them is
    loaded afterwards."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for m in ("jax", "jaxlib", "flax", "lzzx_nerf_tpu"):
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        import lzzx_nerf_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, "lzzx_nerf_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m, v in sys.modules.items() if v is not None and (
            m.split(".")[0] in ("jax", "jaxlib", "flax", "lzzx_nerf_tpu"))]
        assert not bad, bad
        print(len(names), " ".join(sorted(names)))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    n, names = r.stdout.split(" ", 1)
    for want in ("config", "data.provider", "utils.pose", "utils.profiling",
                 "native.framepump", "serving.streaming", "audio.mel",
                 "audio.hubert", "serving.asr", "serving.session",
                 "serving.webapi", "tools.identity"):
        assert f"lzzx_nerf_tpu_torch.{want}" in names.split(), want
    assert int(n) > 40
