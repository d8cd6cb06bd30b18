"""REST serving API (the port's copy of lzzx_nerf_tpu/serving/webapi.py over
the port's InferenceSession; reference webapi.py, re-built on the stdlib
http server: same route surface and flow):

  POST /api/model_select   {"model": "<name>"}       switch identity
  POST /api/audio_upload   wav bytes (Content-Type audio/wav) or
                           {"aud_path": "..."} JSON  extract features
  GET  /api/inference                                start the render loop
  GET  /api/status                                   health/progress
  POST /api/audio_chunk    wav bytes or .npy feature bytes — LIVE mode:
                           append a segment, render starts immediately
  POST /api/audio_end                                finish the live stream

Flow (reference webapi.py:70-204): model_select re-points workspace/ckpt and
(with ffmpeg+RTMP configured) starts the silent wait-video loop;
audio_upload runs the HuBERT front-end and injects features into the
inference dataset; inference spawns the streaming render thread that pushes
raw frames into the configured sink (RTMP/mp4/raw).

An identity <model> is the dataset directory <data_root>/<model> and the
workspace <trial_root>/trial_<model> holding production_state.pkl.

    python -m lzzx_nerf_tpu_torch.serving.webapi --data-root data \
        --trial-root . [--sink raw --out frames.raw] [--device cpu]

serves on the GPU unless --device names another device.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..config import Config
from .session import InferenceSession
from .streaming import WaitVideoLoop, make_sink


def _parse_multipart_file(body: bytes, ctype: str,
                          field: str = "audio") -> bytes:
    """Minimal multipart/form-data parser for the reference client's
    upload shape (request.files['audio'], reference webapi.py:110-118):
    returns the named file part's payload. Stdlib-only (cgi was removed
    in Python 3.13)."""
    import re

    m = re.search(r'boundary="?([^";]+)"?', ctype)
    if not m:
        raise ValueError("multipart body without a boundary parameter")
    for part in body.split(b"--" + m.group(1).encode()):
        head, sep, payload = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        # [;\s] prefix so a filename="audio" on another field can't match
        if re.search(br'[;\s]name="' + re.escape(field.encode()) + br'"',
                     head):
            # exactly one CRLF precedes the next boundary marker
            return payload[:-2] if payload.endswith(b"\r\n") else payload
    raise ValueError(f"multipart body lacks a {field!r} file field")


class ServerState:
    def __init__(self, cfg: Config, data_root: str = "data",
                 trial_root: str = ".", sink_kind: str = "null",
                 rtmp_url: str = "", out_path: str = "",
                 face_optimize: bool = False, device=None):
        self.cfg = cfg
        self.data_root = data_root
        self.trial_root = trial_root
        self.sink_kind = sink_kind
        self.rtmp_url = rtmp_url
        self.out_path = out_path
        # GFPGAN face restoration on every outgoing frame (reference
        # faceOptimize, TrainerUtil.py:743-757); needs the optional gfpgan
        # package and rgb24 sinks
        self.face_optimize = face_optimize
        self.session = InferenceSession(cfg, device=device)
        self.hubert = None          # lazy: needs pretrained weights
        self.model_name: Optional[str] = None
        self.audio_path: str = ""   # last uploaded wav (muxed into streams)
        self.num_aud_frames = 0
        self.busy = False
        self.frames_done = 0
        self.run_seq = 0      # bumped per render run (wait=1 pins to one)
        self.last_error: Optional[str] = None
        self.wait_loop: Optional[WaitVideoLoop] = None
        self.hls_has_audio = False   # set when an hls sink is built
        self.live_q: Optional[queue.Queue] = None   # live-mode segment feed
        self._live_streamer = None   # HubertStreamer (carried wav lattice)
        self._live_ending = False    # end sentinel posted, tail flushing
        self.lock = threading.Lock()
        # serializes live segment decode->enqueue (chunk order = playback
        # order) WITHOUT holding the state lock through feature extraction
        self._feed_lock = threading.Lock()

    @property
    def hls_dir(self) -> Optional[str]:
        """Directory the HLS sink packages into (served at GET /hls/) —
        only meaningful for the hls sink kinds."""
        if self.sink_kind in ("hls", "hls-fmp4"):
            return self.out_path or "hls_out"
        return None

    # -- operations (called by the HTTP handlers) --------------------------

    def model_select(self, model: str) -> dict:
        # harden the user-supplied name against path traversal: a model name
        # must be a plain directory name under data_root
        if (not model or os.path.basename(model) != model
                or model in (".", "..")):
            raise ValueError(f"invalid model name {model!r}")
        data_path = os.path.join(self.data_root, model)
        workspace = os.path.join(self.trial_root, f"trial_{model}")
        self.session.load_model(data_path, workspace)
        self.model_name = model
        if self.rtmp_url:
            wait = os.path.join(data_path, "wait.mp4")
            if os.path.exists(wait):
                self.wait_loop = WaitVideoLoop(wait, self.rtmp_url)
                self.wait_loop.start()
        out = {"model": model,
               "frames": self.session.ds.num_frames,
               "resumed": bool(self.session.resumed)}
        # playback URL like the reference's model_select response
        # ({"status":"success","rtc":...} / "flv" — webapi.py:170-190):
        # the SRS WebRTC URL derives from the RTMP push URL; hls sinks
        # advertise the same-origin playlist
        if self.rtmp_url and self.rtmp_url.startswith("rtmp://"):
            # drop an explicit RTMP port (usually :1935): srs players read
            # a port in a webrtc:// URL as the HTTP API port (1985)
            rest = self.rtmp_url[len("rtmp://"):]
            hostport, _, path_part = rest.partition("/")
            out["rtc"] = ("webrtc://" + hostport.split(":")[0]
                          + "/" + path_part)
        if self.sink_kind in ("hls", "hls-fmp4"):
            out["hls"] = "/hls/stream.m3u8"
        return out

    def list_models(self) -> dict:
        """Identities under data_root that carry a trained dataset."""
        models = []
        if os.path.isdir(self.data_root):
            for name in sorted(os.listdir(self.data_root)):
                d = os.path.join(self.data_root, name)
                if os.path.isdir(d) and os.path.exists(
                        os.path.join(d, "transforms_train.json")):
                    models.append(name)
        return {"models": models, "current": self.model_name}

    def _decode_wav(self, wav_bytes: bytes, live: bool = False) -> np.ndarray:
        """wav bytes -> float32 mono PCM at 16 kHz (reference webapi.py:132
        normalizes uploads to 16k mono via ffmpeg)."""
        from scipy.io import wavfile

        sr, data = wavfile.read(io.BytesIO(wav_bytes))
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        if data.ndim == 2:
            data = data[:, 0]
        if sr != 16000:
            from math import gcd

            from scipy.signal import resample_poly

            if live and not getattr(self, "_warned_live_sr", False):
                # each live chunk is resampled independently: the filter
                # transients at every boundary shift the HuBERT sample
                # lattice slightly (the bundled player records at 16 kHz
                # for exactly this reason)
                print(f"[WARN] live audio chunks arrive at {sr} Hz; "
                      "per-chunk resampling adds boundary artifacts — "
                      "record at 16 kHz for exact features")
                self._warned_live_sr = True
            g = gcd(int(sr), 16000)
            data = resample_poly(data, 16000 // g, sr // g)
        return np.asarray(data, np.float32)

    def _get_hubert(self):
        """The HuBERT extractor, built on first use on the session's
        device."""
        if self.hubert is None:
            from ..audio import HubertFeatureExtractor

            self.hubert = HubertFeatureExtractor(device=self.session.device)
        return self.hubert


    def _live_pcm_feats(self, pcm: np.ndarray):
        """CNN-stride carry across live wav chunks — without it a 1.0 s
        (16000-sample) chunk yields 24 frames instead of 25, ~40 ms of
        cumulative A/V drift per second of speech. Returns None while
        buffering below one whole frame (audio/hubert.py::HubertStreamer
        holds the lattice)."""
        if self._live_streamer is None:
            from ..audio import HubertStreamer

            self._live_streamer = HubertStreamer(self._get_hubert())
        return self._live_streamer.push(pcm)

    _BUSY_UPLOAD = ("inference running — wait for busy=false "
                    "(or stream via /api/audio_chunk)")

    def audio_upload_wav(self, wav_bytes: bytes) -> dict:
        if self.busy or self.live_q is not None:
            # replacing ds.aud_features (and resetting the smooth-lips EMA)
            # under an in-flight render corrupts its remaining frames
            return {"error": self._BUSY_UPLOAD}
        # slow work (decode + HuBERT) OUTSIDE the lock; the guard is
        # re-checked under it before any state mutates — a live stream
        # started during the extraction must not be clobbered
        feats = self._get_hubert().features(self._decode_wav(wav_bytes))
        with self.lock:
            if self.busy or self.live_q is not None:
                return {"error": self._BUSY_UPLOAD}
            # keep the wav on disk so the streaming sinks mux it as the
            # audio track (reference webapi.py:132)
            updir = os.path.join(self.trial_root, "uploads")
            os.makedirs(updir, exist_ok=True)
            self.audio_path = os.path.join(updir, "upload.wav")
            with open(self.audio_path, "wb") as f:
                f.write(wav_bytes)
            self.num_aud_frames = self.session.set_audio_features(feats)
        return {"aud_frames": self.num_aud_frames}

    def audio_upload_npy(self, path: str) -> dict:
        if self.busy or self.live_q is not None:
            return {"error": self._BUSY_UPLOAD}
        # restrict server-side feature files to the configured data root so a
        # client cannot point np.load at arbitrary server paths
        real = os.path.realpath(path)
        root = os.path.realpath(self.data_root)
        if not real.startswith(root + os.sep):
            raise ValueError(
                f"aud_path must live under the data root {self.data_root!r}")
        feats = np.load(real)
        with self.lock:
            if self.busy or self.live_q is not None:
                return {"error": self._BUSY_UPLOAD}
            # feature-only upload: no wav to mux — clear any PREVIOUS
            # utterance's wav so an hls/mp4 sink doesn't pair old audio
            # with these lips
            self.audio_path = ""
            self.num_aud_frames = self.session.set_audio_features(feats)
        return {"aud_frames": self.num_aud_frames}

    def _build_sink(self):
        """Construct the configured frame sink for one render run (shared
        by the utterance and live paths)."""
        ds = self.session.ds
        model_dir = (os.path.join(self.data_root, self.model_name)
                     if self.model_name else "")
        sink = make_sink(self.sink_kind, ds.W, ds.H, fps=25,
                         path=self.out_path, rtmp_url=self.rtmp_url,
                         model_dir=model_dir,
                         audio_path=self.audio_path)
        if hasattr(sink, "clean_output_dir"):
            # drop the previous utterance's playlist/segments so
            # /api/status only re-advertises hls_url once the NEW
            # encode's playlist lands (stale-ENDLIST race)
            sink.clean_output_dir()
        self.hls_has_audio = bool(getattr(sink, "audio_path", None))
        if self.face_optimize:
            from .streaming import FilteredSink, load_face_restorer

            # restoration operates on RGB frames: switch the sink's
            # ingest format before it opens (the session renders in
            # whatever the sink declares)
            sink.pix_fmt = "rgb24"
            sink = FilteredSink(sink, load_face_restorer())
        return sink

    # -- live streaming (chunked audio -> incremental render) ---------------

    def audio_chunk(self, body: bytes, ctype: str) -> dict:
        """Append one live audio segment (the streaming counterpart of
        audio_upload, driving session.run_live): wav bytes -> HuBERT
        features on a chunk-spanning sample lattice (_live_pcm_feats), or
        an .npy payload of pre-extracted per-frame features
        (application/octet-stream). The FIRST chunk starts the live render
        thread; segments render as soon as their attention context is
        buffered; POST /api/audio_end finishes the stream. Live mode
        streams video-only (a file-mux of audio still arriving is
        impossible — deployments pipe live audio to the media server
        directly)."""
        if not getattr(self.session, "_built", False):
            return {"error": "no model loaded — POST /api/model_select "
                    "first"}
        with self._feed_lock:
            return self._audio_chunk_locked(body, ctype)

    def _audio_chunk_locked(self, body: bytes, ctype: str) -> dict:
        with self.lock:
            if self.live_q is None:
                if self.busy:
                    return {"error": "inference already running"}
                self.busy = True
                self.run_seq += 1
                self.frames_done = 0
                self.num_aud_frames = 0
                self.audio_path = ""   # video-only; see docstring
                self._live_streamer = None
                self._live_ending = False
                q = self.live_q = queue.Queue()

                def gen():
                    while True:
                        item = q.get()
                        if item is None:
                            return
                        yield item

                def work():
                    try:
                        sink = self._build_sink()
                        self.session.run_live(
                            gen(), sink,
                            on_frame=lambda i, a: setattr(
                                self, "frames_done", i + 1))
                        self.last_error = None
                    except Exception as e:   # surfaced via /api/status
                        self.last_error = f"{type(e).__name__}: {e}"
                    finally:
                        with self.lock:
                            self.busy = False
                            self.live_q = None
                            self._live_ending = False
                        if self.wait_loop:
                            self.wait_loop.start()

                if self.wait_loop:
                    self.wait_loop.stop()
                threading.Thread(target=work, daemon=True).start()
            elif self._live_ending:
                # the previous stream's tail is still flushing: accepting
                # this chunk would enqueue it BEHIND the end sentinel and
                # silently drop it
                return {"error": "live stream is ending — wait for "
                        "busy=false, then start a new one"}
            q = self.live_q
        # feature extraction happens OUTSIDE the state lock (HuBERT can
        # take ~the chunk's own duration on CPU; holding self.lock here
        # would stall status/end/model_select behind every chunk). The
        # dedicated _feed_lock held around this method is what serializes
        # chunk order = playback order.
        if "wav" in ctype:
            feats = self._live_pcm_feats(self._decode_wav(body, live=True))
            if feats is None:   # buffering below one whole frame
                return {"queued_frames": 0, "live": True}
        else:
            feats = np.load(io.BytesIO(body))
        feats = np.asarray(feats, np.float32)
        if len(feats):
            with self.lock:
                if self.live_q is not q:
                    # the stream ended (or was replaced) mid-extraction
                    return {"error": "live stream ended during feature "
                            "extraction — chunk dropped"}
                q.put(feats)
                self.num_aud_frames += int(len(feats))
        return {"queued_frames": int(len(feats)), "live": True}

    def audio_end(self) -> dict:
        """Finish the live stream: discard the sub-frame PCM remainder
        (exactly what the offline extractor's odd-step truncation drops),
        render the buffered lookahead frames, close the sink. Takes the
        feed lock first so an in-flight chunk's features land BEFORE the
        end sentinel."""
        with self._feed_lock:
            with self.lock:
                q = self.live_q
                if q is None:
                    return {"error": "no live stream in progress"}
                if self._live_ending:
                    return {"error": "live stream already ending"}
                self._live_ending = True
                if self._live_streamer is not None:
                    self._live_streamer.flush()
                    self._live_streamer = None
                q.put(None)
        return {"ended": True}

    def start_inference(self) -> dict:
        if not getattr(self.session, "_built", False):
            return {"error": "no model loaded — POST /api/model_select first"}
        with self.lock:
            if self.busy:
                return {"error": "inference already running"}
            self.busy = True
            self.run_seq += 1
        if self.wait_loop:
            self.wait_loop.stop()
        self.frames_done = 0

        def work():
            try:
                sink = self._build_sink()

                def on_frame(i, arr):
                    self.frames_done = i + 1

                n, dt = self.session.run(sink, on_frame=on_frame)
                self.last_error = None
            except Exception as e:  # surfaced via /api/status
                self.last_error = f"{type(e).__name__}: {e}"
            finally:
                self.busy = False
                if self.wait_loop:
                    self.wait_loop.start()

        threading.Thread(target=work, daemon=True).start()
        return {"started": True, "frames": self.num_aud_frames}

    def status(self) -> dict:
        # result_ready names a finished mp4; hls_url names the live playlist
        # the browser player attaches via MSE while frames still render
        # (reference ##PLAY## sentinel flow, webrtc.py:160-180)
        hls_ready = bool(
            self.hls_dir
            and os.path.exists(os.path.join(self.hls_dir, "stream.m3u8")))
        return {"model": self.model_name, "busy": self.busy,
                # the poll itself succeeded; last_error describes the LAST
                # RUN, not this request — without the explicit success a
                # reference-compat client would see status:'fail' on every
                # poll after one failed render
                "status": "success",
                "live": self.live_q is not None,
                "frames_done": self.frames_done,
                "aud_frames": self.num_aud_frames,
                "result_ready": bool(self.sink_kind in ("mp4", "rtmp")
                                     and self.out_path
                                     and os.path.exists(self.out_path)
                                     and not self.busy),
                "hls_url": "/hls/stream.m3u8" if hls_ready else None,
                # the bundled MSE player needs to know the segment flavor
                # (fmp4 appends directly; mpegts needs native HLS/hls.js)
                # and whether an audio track was muxed (codec string must
                # match the init segment's tracks exactly)
                "hls_type": ("fmp4" if self.sink_kind == "hls-fmp4"
                             else "mpegts") if hls_ready else None,
                "hls_codecs": ("avc1.64001f,mp4a.40.2"
                               if self.hls_has_audio else "avc1.64001f")
                              if hls_ready else None,
                "error": self.last_error}


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            # additive reference-client compat: its frontend branches on
            # data.status === "success" (webapi.py:141-200 returns
            # {"status":"success"/"fail"}); every existing field stays
            payload.setdefault(
                "status", "fail" if payload.get("error") else "success")
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            try:
                if self.path.startswith("/api/inference"):
                    from urllib.parse import parse_qs, urlparse

                    r = state.start_inference()
                    qs = parse_qs(urlparse(self.path).query)
                    if qs.get("wait") == ["1"] and r.get("started"):
                        # reference-compat blocking form: its GET
                        # /api/inference returns only after the render
                        # completes (webapi.py:70-107); ours is async by
                        # default with /api/status polling. Bounded, and
                        # pinned to THIS run via run_seq — a new run
                        # started meanwhile must not report its progress
                        # as ours.
                        import time as _time

                        seq = state.run_seq
                        deadline = _time.time() + 3600
                        while (state.busy and state.run_seq == seq
                               and _time.time() < deadline):
                            _time.sleep(0.2)
                        if state.run_seq != seq:
                            r = dict(r, done=True,
                                     error="superseded by a newer run")
                        elif state.busy:
                            r = dict(r, done=False,
                                     error="wait=1 timed out after 1h")
                        else:
                            r = dict(r, done=True,
                                     frames_done=state.frames_done,
                                     error=state.last_error)
                    self._send(200, r)
                elif self.path.startswith("/api/status"):
                    self._send(200, state.status())
                elif self.path.startswith("/api/models"):
                    self._send(200, state.list_models())
                elif self.path.startswith("/result.mp4"):
                    if state.busy:
                        # ffmpeg still has the file open (moov atom
                        # unwritten) — a partial read is unplayable
                        return self._send(409, {"error": "rendering in "
                                                "progress; poll /api/status"})
                    if not (state.out_path
                            and os.path.exists(state.out_path)):
                        return self._send(404, {"error": "no result yet"})
                    data = open(state.out_path, "rb").read()
                    self.send_response(200)
                    self.send_header("Content-Type", "video/mp4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/hls/"):
                    # live HLS artifacts (playlist + segments) for the
                    # bundled MSE player. Same-origin so player.html needs
                    # no CORS; name is traversal-hardened like model_select
                    if not state.hls_dir:
                        return self._send(404, {"error": "server not "
                                                "started with an hls sink"})
                    name = self.path[len("/hls/"):].split("?", 1)[0]
                    ext = os.path.splitext(name)[1]
                    if (os.path.basename(name) != name or not name
                            or ext not in
                            (".m3u8", ".ts", ".m4s", ".mp4")):
                        return self._send(404, {"error": "bad hls path"})
                    fp = os.path.join(state.hls_dir, name)
                    if not os.path.exists(fp):
                        return self._send(404, {"error": f"{name} not "
                                                "written yet"})
                    data = open(fp, "rb").read()
                    mime = {".m3u8": "application/vnd.apple.mpegurl",
                            ".ts": "video/mp2t"}.get(ext, "video/mp4")
                    self.send_response(200)
                    self.send_header("Content-Type", mime)
                    self.send_header("Content-Length", str(len(data)))
                    if ext == ".m3u8":
                        # the live playlist is re-polled — never cache it
                        self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/static/"):
                    # optional deployment extras next to player.html (e.g.
                    # a vendored hls.min.js for mpegts playlists — the
                    # fmp4 path needs nothing here); same traversal
                    # hardening as /hls/
                    name = self.path[len("/static/"):].split("?", 1)[0]
                    ext = os.path.splitext(name)[1]
                    if (os.path.basename(name) != name or not name
                            or ext not in (".js", ".css", ".html")):
                        return self._send(404, {"error": "bad static path"})
                    fp = os.path.join(os.path.dirname(__file__), "static",
                                      name)
                    if not os.path.exists(fp):
                        return self._send(404,
                                          {"error": f"{name} not deployed"})
                    data = open(fp, "rb").read()
                    mime = {".js": "text/javascript",
                            ".css": "text/css"}.get(ext, "text/html")
                    self.send_response(200)
                    self.send_header("Content-Type", mime)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/" or self.path.startswith("/player"):
                    page = os.path.join(os.path.dirname(__file__), "static",
                                        "player.html")
                    body = open(page, "rb").read()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": f"unknown route {self.path}"})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path.startswith("/api/model_select"):
                    payload = json.loads(body or b"{}")
                    if "model" not in payload:
                        return self._send(400, {"error": "missing 'model'"})
                    self._send(200, state.model_select(payload["model"]))
                elif self.path.startswith("/api/audio_chunk"):
                    ctype = self.headers.get("Content-Type", "")
                    self._send(200, state.audio_chunk(body, ctype))
                elif self.path.startswith("/api/audio_end"):
                    self._send(200, state.audio_end())
                elif self.path.startswith("/api/audio_upload"):
                    ctype = self.headers.get("Content-Type", "")
                    # most-specific first: a random multipart boundary can
                    # contain the substring "json"
                    if "multipart/form-data" in ctype:
                        # the reference client uploads as a form file
                        # field named 'audio' (webapi.py:110-118)
                        wav = _parse_multipart_file(body, ctype)
                        self._send(200, state.audio_upload_wav(wav))
                    elif "json" in ctype:
                        payload = json.loads(body or b"{}")
                        if "aud_path" not in payload:
                            return self._send(400,
                                              {"error": "missing 'aud_path'"})
                        self._send(200,
                                   state.audio_upload_npy(payload["aud_path"]))
                    else:
                        self._send(200, state.audio_upload_wav(body))
                else:
                    self._send(404, {"error": f"unknown route {self.path}"})
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"malformed JSON body: {e}"})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(cfg: Config, host: str = "127.0.0.1", port: int = 7860,
          **state_kw) -> ThreadingHTTPServer:
    state = ServerState(cfg, **state_kw)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state
    return httpd


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (use 0.0.0.0 to expose externally)")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--trial-root", default=".")
    ap.add_argument("--sink", default="null",
                    choices=["null", "raw", "mp4", "rtmp", "hls",
                             "hls-fmp4"])
    ap.add_argument("--rtmp-url", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--asr_model", default="hubert",
                    help="audio feature family of the datasets "
                         "(hubert | deepspeech | esperanto)")
    ap.add_argument("--config-json", default="",
                    help="path to a Config json for full control")
    ap.add_argument("--face-optimize", action="store_true",
                    help="GFPGAN face restoration on outgoing frames "
                         "(needs the optional gfpgan package; reference "
                         "faceOptimize)")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain PyTorch "
                         "versions of the kernels")
    args = ap.parse_args()

    if args.config_json:
        cfg = Config.from_json(open(args.config_json).read())
    else:
        cfg = Config(asr_model=args.asr_model)
    httpd = serve(cfg, host=args.host, port=args.port,
                  data_root=args.data_root,
                  trial_root=args.trial_root, sink_kind=args.sink,
                  rtmp_url=args.rtmp_url, out_path=args.out,
                  face_optimize=args.face_optimize, device=args.device)
    print(f"[INFO] serving on :{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
