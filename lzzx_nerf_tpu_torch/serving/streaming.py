"""Frame sinks: raw RGB frames out of the renderer into a video transport
(the port's copy of lzzx_nerf_tpu/serving/streaming.py).

Re-design of reference mq_consume/ConsumeMQByWebRTC.py, which pipes rawvideo
into ffmpeg subprocesses (x264 -> RTMP to an SRS server + a local mp4, with
an optional crop-overlay composite onto the original video) and loops a
silent wait.mp4 between utterances.

The transport is pluggable here: FfmpegRtmpSink reproduces the reference
behaviour when ffmpeg exists; RawFileSink / NullSink serve headless and test
environments. All sinks take rgb24 bytes of fixed WxH at a fixed fps.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import Optional


class FrameSink:
    """Interface: open() -> push(frame_bytes) xN -> close().
    pix_fmt declares the raw layout the sink ingests ("rgb24" or
    "yuv420p"); the serving session renders frames in that format."""

    pix_fmt = "rgb24"

    def open(self) -> None: ...

    def push(self, rgb24: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None: ...


class NullSink(FrameSink):
    def __init__(self):
        self.count = 0

    def push(self, rgb24: bytes) -> None:
        self.count += 1


class RawFileSink(FrameSink):
    """Appends raw rgb24 frames to one file (headless fallback)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self.count = 0

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "wb")

    def push(self, rgb24: bytes) -> None:
        if self._f is None:
            self.open()
        self._f.write(rgb24)
        self.count += 1

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class _FfmpegSink(FrameSink):
    """Base for ffmpeg-backed sinks: rawvideo on stdin at (W, H, fps)
    (reference ConsumeMQByWebRTC.py:87-133). pix_fmt rgb24 or yuv420p —
    serving prefers yuv420p (half the device->host bytes; the encoder
    converts to 4:2:0 anyway)."""

    def __init__(self, width: int, height: int, fps: int = 25,
                 pix_fmt: str = "yuv420p"):
        self.width, self.height, self.fps = width, height, fps
        self.pix_fmt = pix_fmt
        self.proc: Optional[subprocess.Popen] = None
        self.count = 0
        self._closed = False
        self.closed_ok = False   # set by close(): clean ffmpeg exit

    @property
    def frame_bytes(self) -> int:
        n = self.width * self.height
        return n * 3 // 2 if self.pix_fmt == "yuv420p" else n * 3

    def _output_args(self):
        raise NotImplementedError

    def _stdin_args(self) -> list:
        """rawvideo-over-stdin argv prefix — the ONE place the stdin
        contract lives (overlay's command() reuses it; an override drift
        here already shipped a pump regression once)."""
        return [
            "ffmpeg", "-y", "-loglevel", "error",
            "-f", "rawvideo", "-pix_fmt", self.pix_fmt,
            "-s", f"{self.width}x{self.height}", "-r", str(self.fps),
            "-i", "-",
        ]

    def open(self) -> None:
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("ffmpeg not found on PATH")
        cmd = self._stdin_args() + self._output_args()
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        self._attach_pump()

    def _attach_pump(self) -> None:
        # native ring-buffer writer (native/framepump.py): the render loop's
        # push() returns after a memcpy; a C++ thread feeds ffmpeg and
        # absorbs encoder stalls without holding the GIL
        self.pump = None
        try:
            from ..native import FramePump

            self.pump = FramePump(self.proc.stdin.fileno(), self.frame_bytes)
        except Exception:
            pass  # pure-Python writes below

    def push(self, rgb24: bytes) -> None:
        if self.proc is None:
            if self._closed:
                # a lazy re-open here would relaunch ffmpeg with -y and
                # clobber the just-finalized output with a 1-frame file
                raise RuntimeError("push() on a closed sink")
            self.open()
        if self.pump is not None:
            self.pump.push(rgb24)
        else:
            self.proc.stdin.write(rgb24)
        self.count += 1

    def close(self) -> None:
        self._closed = True
        if self.proc is not None:
            try:
                if self.pump is not None:
                    self.pump.close()
                    self.pump = None
                self.proc.stdin.close()
                self.closed_ok = self.proc.wait(timeout=30) == 0
            except Exception:
                self.closed_ok = False
                self.proc.kill()
                self.proc.wait()   # reap — kill() alone leaves a zombie
            self.proc = None


class FfmpegMp4Sink(_FfmpegSink):
    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 audio_path: Optional[str] = None):
        super().__init__(width, height, fps)
        self.path = path
        # mux the driving wav like the reference's mp4 writer
        # (TrainerUtil.py:713-741 concats audio into the final mp4)
        self.audio_path = audio_path

    def _output_args(self):
        args = []
        if self.audio_path:
            args += ["-i", self.audio_path, "-map", "0:v:0",
                     "-map", "1:a:0", "-c:a", "aac", "-shortest"]
        return args + ["-c:v", "libx264", "-pix_fmt", "yuv420p",
                       "-r", str(self.fps), self.path]


class FfmpegHlsSink(_FfmpegSink):
    """HLS packager: m3u8 playlist + segments (the reference's offline
    test() pipes frames to an HLS writer and logs a ##M3U8##SUCCESS:<path>
    sentinel the frontend greps — TrainerUtil.py:759-832).

    segment_type:
      * "mpegts" (default) — .ts segments, plays natively on Safari and
        via hls.js elsewhere (the reference's CDN-fetched player path,
        webrtc.py:30-36).
      * "fmp4" — CMAF init.mp4 + .m4s fragments. This is the segment
        format the bundled dependency-free player understands: fMP4
        fragments append directly into a Media Source Extensions
        SourceBuffer, so player.html can play the live stream in any
        MSE browser with ~80 lines of inline JS instead of a vendored
        hls.js build (serving/static/player.html::attachHls)."""

    def __init__(self, out_dir: str, width: int, height: int, fps: int = 25,
                 segment_seconds: int = 5, segment_type: str = "mpegts",
                 audio_path: Optional[str] = None):
        super().__init__(width, height, fps)
        if segment_type not in ("mpegts", "fmp4"):
            raise ValueError(f"segment_type must be mpegts|fmp4, "
                             f"got {segment_type!r}")
        self.out_dir = out_dir
        self.segment_seconds = segment_seconds
        self.segment_type = segment_type
        # mux the driving wav as an AAC track like the reference consumer
        # (ConsumeMQByWebRTC.py:87-133) — without it the live stream plays
        # silent lips
        self.audio_path = audio_path
        self.playlist = os.path.join(out_dir, "stream.m3u8")

    def clean_output_dir(self) -> None:
        """Remove a previous utterance's playlist/segments so a poller never
        attaches to the stale ENDLIST stream while the new encode starts."""
        if not os.path.isdir(self.out_dir):
            return
        for name in os.listdir(self.out_dir):
            if (name.endswith((".m3u8", ".ts", ".m4s"))
                    or name == "init.mp4"):
                try:
                    os.remove(os.path.join(self.out_dir, name))
                except OSError:
                    pass

    def _output_args(self):
        os.makedirs(self.out_dir, exist_ok=True)
        args = []
        if self.audio_path:
            # second input + explicit maps (video from stdin, audio track);
            # -shortest ends the mux with the video
            args += ["-i", self.audio_path, "-map", "0:v:0",
                     "-map", "1:a:0", "-c:a", "aac", "-shortest"]
        args += ["-c:v", "libx264", "-pix_fmt", "yuv420p",
                 "-g", str(self.fps * 2), "-f", "hls",
                 "-hls_time", str(self.segment_seconds),
                 # temp_file: playlist/segments land via rename, so a live
                 # poller never reads a torn half-written m3u8 (the MSE
                 # client would misread it as a replaced stream)
                 "-hls_flags", "temp_file",
                 "-hls_playlist_type", "event"]
        if self.segment_type == "fmp4":
            args += ["-hls_segment_type", "fmp4",
                     "-hls_fmp4_init_filename", "init.mp4",
                     "-hls_segment_filename",
                     os.path.join(self.out_dir, "seg_%05d.m4s")]
        else:
            args += ["-hls_segment_filename",
                     os.path.join(self.out_dir, "seg_%05d.ts")]
        return args + [self.playlist]

    def close(self) -> None:
        super().close()
        # sentinel the reference frontend greps (TrainerUtil.py:810-817) —
        # only on a CLEAN encoder exit: a killed ffmpeg leaves an 'event'
        # playlist without EXT-X-ENDLIST that players stall on forever
        if self.closed_ok and os.path.exists(self.playlist):
            print(f"##M3U8##SUCCESS:{self.playlist}")


class FfmpegRtmpSink(_FfmpegSink):
    """x264 → RTMP (to an SRS/RTMP media server, which converts to
    WebRTC/HLS for the browser — reference run.sh + static/jswebrtc).
    Optionally also writes a local mp4 copy like the reference."""

    def __init__(self, rtmp_url: str, width: int, height: int, fps: int = 25,
                 local_mp4: Optional[str] = None):
        super().__init__(width, height, fps)
        self.rtmp_url = rtmp_url
        self.local_mp4 = local_mp4

    def _output_args(self):
        args = ["-c:v", "libx264", "-preset", "ultrafast", "-tune",
                "zerolatency", "-pix_fmt", "yuv420p", "-g", str(self.fps),
                "-f", "flv", self.rtmp_url]
        if self.local_mp4:
            args += ["-c:v", "libx264", "-pix_fmt", "yuv420p", self.local_mp4]
        return args


class FfmpegOverlaySink(_FfmpegSink):
    """Composite the rendered crop back onto the original full-frame video
    while streaming (reference ConsumeMQByWebRTC.py:87-133): the model was
    trained on a crop of the source video (video_crop_parameter.json from
    the crop tool, preprocess/crop.py), and the stream overlays the rendered
    WxH frames onto `readySourceVideo.mp4` (the source with the crop region
    neutralised) at (x, y), muxing the driving audio when given."""

    def __init__(self, width: int, height: int, fps: int = 25,
                 ready_video: str = "", crop_xy: tuple = (0, 0),
                 audio_path: Optional[str] = None,
                 rtmp_url: Optional[str] = None,
                 local_mp4: Optional[str] = None):
        super().__init__(width, height, fps)
        if not (rtmp_url or local_mp4):
            raise ValueError("overlay sink needs an rtmp_url and/or mp4 path")
        self.ready_video = ready_video
        self.crop_xy = crop_xy
        self.audio_path = audio_path
        self.rtmp_url = rtmp_url
        self.local_mp4 = local_mp4

    def _input_args(self):
        args = ["-stream_loop", "-1", "-i", self.ready_video]
        if self.audio_path:
            args += ["-i", self.audio_path]
        return args

    def _output_args(self):
        x, y = self.crop_xy
        n_out = int(bool(self.rtmp_url)) + int(bool(self.local_mp4))
        split = (f",split={n_out}[out1][out2]" if n_out == 2 else "[out1]")
        # [1:v] = looped source video (base), [0:v] = rendered crop (top).
        # shortest=1: end the composite when the CROP stream (stdin) ends —
        # the base is -stream_loop -1 and never EOFs, so without it close()
        # would stall 30 s and then kill ffmpeg mid-write (no moov atom)
        fc = f"[1:v][0:v]overlay={x}:{y}:shortest=1{split}"
        args = ["-filter_complex", fc]
        amap = ["-map", "2:a:0", "-c:a", "aac"] if self.audio_path else []
        tag = 1
        if self.rtmp_url:
            args += (["-map", f"[out{tag}]"] + amap
                     + ["-c:v", "libx264", "-preset", "ultrafast", "-tune",
                        "zerolatency", "-pix_fmt", "yuv420p",
                        "-g", str(self.fps), "-f", "flv", self.rtmp_url])
            tag += 1
        if self.local_mp4:
            args += (["-map", f"[out{tag}]"] + amap
                     + ["-c:v", "libx264", "-pix_fmt", "yuv420p",
                        "-shortest", self.local_mp4])
        return args

    def command(self) -> list:
        """The full ffmpeg argv (exposed for tests; open() runs exactly
        this). stdin format follows self.pix_fmt — the session renders
        frames in whatever the sink declares."""
        return self._stdin_args() + self._input_args() + self._output_args()

    def open(self) -> None:
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("ffmpeg not found on PATH")
        self.proc = subprocess.Popen(self.command(), stdin=subprocess.PIPE)
        self._attach_pump()


class WaitVideoLoop:
    """Loops a silent placeholder video to the RTMP endpoint between
    utterances (reference ConsumeMQByWebRTC.pushWaitVideoForModel,
    ConsumeMQByWebRTC.py:167-194)."""

    def __init__(self, wait_mp4: str, rtmp_url: str):
        self.wait_mp4 = wait_mp4
        self.rtmp_url = rtmp_url
        self.proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self.proc is not None or shutil.which("ffmpeg") is None:
                return
            self.proc = subprocess.Popen([
                "ffmpeg", "-loglevel", "error", "-re", "-stream_loop", "-1",
                "-i", self.wait_mp4, "-c", "copy", "-f", "flv", self.rtmp_url,
            ])

    def stop(self) -> None:
        with self._lock:
            if self.proc is not None:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5)
                except Exception:
                    self.proc.kill()
                    self.proc.wait()   # reap the killed process
                self.proc = None


class FilteredSink(FrameSink):
    """Wraps a sink with a per-frame postprocess filter (an np [H, W, 3]
    uint8 -> same callable) — the slot the reference feeds GFPGAN face
    restoration into (TrainerUtil.optimizeResultAndWriteVideoFragmentConsume,
    TrainerUtil.py:743-757). rgb24 inner sinks only: restoration models
    operate on RGB frames."""

    def __init__(self, inner: FrameSink, frame_filter):
        if inner.pix_fmt != "rgb24":
            raise ValueError(
                "FilteredSink requires an rgb24 inner sink (frame filters "
                f"operate on RGB frames); got pix_fmt={inner.pix_fmt!r}. "
                "Construct the inner sink with pix_fmt='rgb24'.")
        if not (getattr(inner, "width", 0) and getattr(inner, "height", 0)):
            raise ValueError(
                "FilteredSink needs a sink with width/height to decode "
                f"frames for the filter; {type(inner).__name__} has none "
                "(raw/null sinks are dimensionless byte pipes)")
        self.inner = inner
        self.frame_filter = frame_filter
        self.pix_fmt = inner.pix_fmt
        self.count = 0

    def open(self) -> None:
        self.inner.open()

    def push(self, rgb24: bytes) -> None:
        import numpy as np

        w, h = self.inner.width, self.inner.height
        frame = np.frombuffer(rgb24, np.uint8).reshape(h, w, 3)
        rgb24 = np.ascontiguousarray(
            self.frame_filter(frame)).astype(np.uint8).tobytes()
        self.inner.push(rgb24)
        self.count += 1

    def close(self) -> None:
        self.inner.close()


def load_face_restorer(upscale: int = 1, model_path: Optional[str] = None):
    """GFPGAN face-restoration filter if the optional dependency is
    installed (the reference's face_optimize/gfpgan_util.GFPGANUtil);
    raises with instructions otherwise. Returns a FilteredSink-compatible
    frame filter. Weights path: `model_path` arg, else $LZZX_GFPGAN_PTH,
    else ./GFPGANv1.4.pth — checked up front so a missing file fails here
    with a clear message, not mid-stream in the worker thread."""
    try:
        from gfpgan import GFPGANer  # optional; not bundled
    except ImportError as exc:
        raise RuntimeError(
            "face restoration needs the optional 'gfpgan' package (pip "
            "install gfpgan) and its pretrained weights; the framework "
            "does not bundle it") from exc

    model_path = (model_path or os.environ.get("LZZX_GFPGAN_PTH")
                  or "GFPGANv1.4.pth")
    if not os.path.exists(model_path):
        raise RuntimeError(
            f"GFPGAN weights not found at {model_path!r}; pass model_path "
            "or set LZZX_GFPGAN_PTH")
    restorer = GFPGANer(model_path=model_path, upscale=upscale)

    def restore(frame):
        import numpy as np

        # cv2 inside GFPGAN rejects negative-stride/read-only views (the
        # incoming frame is an np.frombuffer view) — materialize the BGR
        # copy before and after
        _, _, out = restorer.enhance(
            np.ascontiguousarray(frame[..., ::-1]), has_aligned=False,
            only_center_face=True, paste_back=True)
        return np.ascontiguousarray(out[..., ::-1])

    return restore


def make_sink(kind: str, width: int, height: int, fps: int = 25,
              path: str = "", rtmp_url: str = "",
              model_dir: str = "", audio_path: str = "") -> FrameSink:
    """Sink factory. For rtmp/mp4 kinds, when `model_dir` carries the crop
    tool's video_crop_parameter.json + readySourceVideo.mp4, the stream
    composites the rendered crop onto the source video like the reference
    (ConsumeMQByWebRTC.py:87-133); plain full-frame sinks otherwise."""
    if kind in ("rtmp", "mp4") and model_dir:
        import json

        crop_cfg = os.path.join(model_dir, "video_crop_parameter.json")
        ready = os.path.join(model_dir, "readySourceVideo.mp4")
        if os.path.exists(crop_cfg) and os.path.exists(ready):
            with open(crop_cfg) as f:
                param = json.load(f)
            return FfmpegOverlaySink(
                width, height, fps, ready_video=ready,
                crop_xy=(int(param.get("x", 0)), int(param.get("y", 0))),
                audio_path=audio_path or None,
                rtmp_url=rtmp_url or None if kind == "rtmp" else None,
                local_mp4=path or None)
    if kind == "rtmp":
        return FfmpegRtmpSink(rtmp_url, width, height, fps, local_mp4=path or None)
    if kind == "mp4":
        return FfmpegMp4Sink(path, width, height, fps,
                             audio_path=audio_path or None)
    if kind in ("hls", "hls-fmp4"):
        return FfmpegHlsSink(path or "hls_out", width, height, fps,
                             segment_type="fmp4" if kind == "hls-fmp4"
                             else "mpegts",
                             audio_path=audio_path or None)
    if kind == "raw":
        return RawFileSink(path)
    return NullSink()
