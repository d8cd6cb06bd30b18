"""The port's serving stack on the trained state: the identity tool, the
torso composite, and the HTTP API (serving/webapi.py) over the port's
InferenceSession.

The identity is tools/identity.py's: the trained state's pose 0 (the only
one inside the block march's drift envelope at 128²) written as a 128²
dataset with its intrinsics, landmarks, blinks, seeded 29-wide features
and a seeded bc.jpg, and a workspace trial_<model> holding the state.
Sessions serve it at the whole-frame ray budget and a stage-2 budget of
the ray budget, so no escape fires and every run of the same features
renders the same bytes. HuBERT (a WAV upload) is replaced by a stand-in
extractor: its weights are not in the repository."""

import io
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from lzzx_nerf_tpu.serving.webapi import \
    _parse_multipart_file as jax_parse_multipart
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
from lzzx_nerf_tpu_torch.serving import InferenceSession, ServingSession
from lzzx_nerf_tpu_torch.serving.state_io import load_trained_state
from lzzx_nerf_tpu_torch.serving.streaming import NullSink
from lzzx_nerf_tpu_torch.serving.webapi import (ServerState,
                                                _parse_multipart_file, serve)
from lzzx_nerf_tpu_torch.tools.identity import write_identity
from lzzx_nerf_tpu_torch.utils.audio import get_audio_features_np
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(REPO, "trained", "production_state.pkl")
CFG = dict(asr_model="deepspeech", infer_chunk=2, budget_frac=1.0,
           infer_stage2_frac=1.0)


def _quiet(msg):
    pass


def _feats(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16, 29)).astype(np.float32)


class _YuvSink(NullSink):
    pix_fmt = "yuv420p"


@pytest.fixture(scope="module")
def ident(tmp_path_factory):
    root = tmp_path_factory.mktemp("ident")
    got = write_identity(str(root), STATE, model="ident", res=128,
                         n_poses=1)
    return str(root), got


def test_identity_poses_are_the_states(tmp_path):
    """Every pose of the trained state survives transforms_train.json and
    the provider's nerf_matrix_to_ngp bit for bit; the intrinsics are the
    state's scaled to the resolution."""
    got = write_identity(str(tmp_path), STATE, res=32)
    meta = load_trained_state(STATE)["meta"]
    ds = NeRFDataset(Config(path=got["data"], asr_model="deepspeech"))
    assert ds.H == ds.W == 32 and ds.num_frames == len(meta["poses"]) == 32
    np.testing.assert_array_equal(ds.poses, np.asarray(meta["poses"]))
    assert ds.intrinsics == tuple(float(v) / 16 for v in meta["intrinsics"])
    assert got["codec"] and os.path.exists(os.path.join(got["data"],
                                                        "bc.jpg"))
    assert ds.bg_img.shape == (32, 32, 3) and len(ds.eye_area) == 32
    assert ds.aud_features.shape == (32, 16, 29)
    assert os.path.exists(os.path.join(got["workspace"],
                                       "production_state.pkl"))


def test_torso_composites_as_serving_session(tmp_path):
    """The trained state's torso at 128²: the InferenceSession over a white
    dataset background renders the frames ServingSession renders with the
    same plan, byte for byte (one chunk program); without the torso the
    frames change."""
    ident = write_identity(str(tmp_path), STATE, res=128, n_poses=1)
    kw = dict(CFG, bg_img="white")
    s = InferenceSession(Config(**kw), device="cpu", log=_quiet)
    s.load_model(ident["data"], ident["workspace"])
    assert s.torso is not None
    feats = _feats(3, 21)
    got = {}
    s.set_audio_features(feats)
    s.run(_YuvSink(), on_frame=lambda i, b: got.__setitem__(i, b))
    ref = ServingSession(STATE, device="cpu", res=128, poses=s.poses,
                         chunk=2, log=_quiet, budget=s.budget, k2=s.k2,
                         march_bucket=s.bucket or False,
                         eval_recompact=False,
                         stage2_budget=s.stage2_budget)
    auds = np.stack([get_audio_features_np(feats, 2, i) for i in range(3)])
    out = ref.render(auds, [s.ds.eye_area[0]] * 3)
    assert s.rebuilds == 0 and not ref.rebuild_pending()
    for i in range(3):
        np.testing.assert_array_equal(got[i], out["frames"][i])

    # the same identity without its torso
    with open(STATE, "rb") as f:
        raw = pickle.load(f)
    raw.pop("torso_leaves")
    head_ws = tmp_path / "trial_head"
    head_ws.mkdir()
    with open(head_ws / "production_state.pkl", "wb") as f:
        pickle.dump(raw, f)
    h = InferenceSession(Config(**kw), device="cpu", log=_quiet)
    h.load_model(ident["data"], str(head_ws))
    assert h.torso is None
    got_h = {}
    h.set_audio_features(feats)
    h.run(_YuvSink(), on_frame=lambda i, b: got_h.__setitem__(i, b))
    assert not np.array_equal(got_h[0], got[0])


def test_model_select_hardening_and_list_models(ident):
    root, _ = ident
    st = ServerState(Config(**CFG), data_root=root, trial_root=root,
                     device="cpu")
    for bad in ("", ".", "..", "../ident", "a/b", "/etc"):
        with pytest.raises(ValueError, match="invalid model name"):
            st.model_select(bad)
    assert st.list_models() == {"models": ["ident"], "current": None}
    assert "error" in st.start_inference()
    with pytest.raises(ValueError, match="data root"):
        st.audio_upload_npy(os.path.join(root, "..", "x.npy"))


def test_multipart_parser_matches_jax():
    payload = b"RIFF\x00\x01\r\n\x02binary\r\n"
    boundary = "----testboundary42"
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="other"\r\n\r\n'
        "junk\r\n"
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="audio"; '
        'filename="a.wav"\r\n'
        "Content-Type: audio/wav\r\n\r\n").encode() + payload + (
        f"\r\n--{boundary}--\r\n").encode()
    cases = [
        (body, f"multipart/form-data; boundary={boundary}"),
        (body, f'multipart/form-data; boundary="{boundary}"'),
        (body.replace(b' name="audio"', b' name="sound"'),
         f"multipart/form-data; boundary={boundary}"),
        (body.replace(b' name="audio"', b' name="sound"')
         .replace(b'filename="a.wav"', b'filename="audio"'),
         f"multipart/form-data; boundary={boundary}"),
        (body, "multipart/form-data"),
    ]
    for b, ctype in cases:
        outcome = []
        for parse in (_parse_multipart_file, jax_parse_multipart):
            try:
                outcome.append(parse(b, ctype))
            except ValueError as e:
                outcome.append(("ValueError", str(e)))
        assert outcome[0] == outcome[1], ctype
    assert _parse_multipart_file(*cases[0]) == payload


class _Client:
    def __init__(self, httpd):
        self.base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(self, route):
        try:
            with urllib.request.urlopen(self.base + route) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def post(self, route, body, ctype):
        req = urllib.request.Request(self.base + route, body,
                                     {"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def wait_idle(self):
        for _ in range(600):
            st = json.loads(self.get("/api/status")[2])
            if not st["busy"]:
                return st
            time.sleep(0.1)
        raise TimeoutError("the server stayed busy")


@pytest.fixture
def server(ident, tmp_path):
    started = []

    def start(**kw):
        root, _ = ident
        httpd = serve(Config(**CFG), host="127.0.0.1", port=0,
                      data_root=root, trial_root=root, device="cpu", **kw)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        started.append((httpd, t))
        return httpd, _Client(httpd)

    yield start
    for httpd, t in started:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def test_player_page_and_hls_route(server, tmp_path):
    httpd, c = server(sink_kind="hls-fmp4", out_path=str(tmp_path / "hls"))
    code, headers, page = c.get("/")
    assert code == 200 and headers["Content-Type"].startswith("text/html")
    page = page.decode()
    for hook in ("/api/model_select", "/api/audio_upload", "/api/inference",
                 "/api/status", "result.mp4", "whep", "getUserMedia",
                 "encodeWav", "retryWhep", "attachHls", "playFmp4Hls",
                 "parsePlaylist", "EXT-X-MAP", "hls_url", "useNpy",
                 "aud_path", "audio_chunk", "audio_end", "maybeFlushLive"):
        assert hook in page, hook
    assert c.get("/hls/stream.m3u8")[0] == 404
    os.makedirs(tmp_path / "hls")
    (tmp_path / "hls" / "stream.m3u8").write_text("#EXTM3U\n")
    code, headers, body = c.get("/hls/stream.m3u8")
    assert code == 200 and body == b"#EXTM3U\n"
    assert headers["Content-Type"] == "application/vnd.apple.mpegurl"
    assert headers["Cache-Control"] == "no-store"
    st = json.loads(c.get("/api/status")[2])
    assert st["hls_url"] == "/hls/stream.m3u8" and st["hls_type"] == "fmp4"
    for bad in ("/hls/..%2fstream.m3u8", "/hls/x.txt", "/hls/a/b.ts"):
        assert c.get(bad)[0] == 404, bad
    assert c.get("/static/player.html")[0] == 200
    assert c.get("/static/../webapi.py")[0] == 404
    assert c.get("/nowhere")[0] == 404
    _, c2 = server(sink_kind="null")
    code, _, body = c2.get("/hls/stream.m3u8")
    assert code == 404 and b"hls sink" in body


def test_npy_upload_and_live_stream_reproduce_offline_bytes(ident, server,
                                                           tmp_path):
    """An .npy upload with the blocking GET /api/inference?wait=1, and a
    live /api/audio_chunk ... /api/audio_end stream of .npy segments, each
    write the raw bytes an offline run() of the same features renders."""
    root, got = ident
    feats = _feats(6, 13)
    s = InferenceSession(Config(**CFG), device="cpu", log=_quiet)
    s.load_model(got["data"], got["workspace"])
    offline = {}
    s.set_audio_features(feats)
    s.run(on_frame=lambda i, b: offline.__setitem__(i, b))
    want = b"".join(offline[i].tobytes() for i in range(6))

    raw = tmp_path / "out.raw"
    httpd, c = server(sink_kind="raw", out_path=str(raw))
    code, r = c.post("/api/model_select", json.dumps(
        {"model": "ident"}).encode(), "application/json")
    assert code == 200 and r["model"] == "ident" and r["frames"] == 1, r
    assert c.post("/api/model_select", json.dumps(
        {"model": ".."}).encode(), "application/json")[0] == 400
    npy = os.path.join(root, "utterance.npy")
    np.save(npy, feats)
    code, r = c.post("/api/audio_upload", json.dumps(
        {"aud_path": npy}).encode(), "application/json")
    assert r["aud_frames"] == 6, r
    code, _, body = c.get("/api/inference?wait=1")
    r = json.loads(body)
    assert r["done"] and r["frames_done"] == 6 and r["error"] is None, r
    assert raw.read_bytes() == want
    raw.unlink()

    def npy_bytes(a):
        bio = io.BytesIO()
        np.save(bio, a)
        return bio.getvalue()

    code, r = c.post("/api/audio_chunk", npy_bytes(feats[:2]),
                     "application/octet-stream")
    assert r == {"queued_frames": 2, "live": True, "status": "success"}
    st = json.loads(c.get("/api/status")[2])
    assert st["live"] and st["busy"]
    for part in (feats[2:5], feats[5:]):
        c.post("/api/audio_chunk", npy_bytes(part),
               "application/octet-stream")
    code, r = c.post("/api/audio_end", b"", "application/octet-stream")
    assert r == {"ended": True, "status": "success"}
    st = c.wait_idle()
    assert st["error"] is None and st["frames_done"] == 6, st
    assert not st["live"] and st["aud_frames"] == 6
    assert raw.read_bytes() == want
    r = c.post("/api/audio_end", b"", "application/octet-stream")[1]
    assert "error" in r and r["status"] == "fail"


def test_wav_upload_goes_through_the_feature_extractor(ident, server,
                                                       tmp_path):
    """A WAV upload is decoded to 16 kHz mono and handed to the HuBERT
    extractor (a stand-in here), whose features drive the render; the wav
    is kept for the sinks to mux."""
    root, _ = ident
    httpd, c = server(sink_kind="raw", out_path=str(tmp_path / "o.raw"))
    seen = []

    class FakeHubert:
        def features(self, pcm):
            seen.append(len(pcm))
            return _feats(max(1, len(pcm) // 640), 3)

    httpd.state.hubert = FakeHubert()
    c.post("/api/model_select", json.dumps({"model": "ident"}).encode(),
           "application/json")
    bio = io.BytesIO()
    with wave.open(bio, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(3200) / 9.0) * 8000)
                      .astype(np.int16).tobytes())
    code, r = c.post("/api/audio_upload", bio.getvalue(), "audio/wav")
    assert code == 200 and r["aud_frames"] == 5 and seen == [3200], r
    assert httpd.state.audio_path.endswith("upload.wav")
