"""The port's preprocessing (lzzx_nerf_tpu_torch/preprocess/) against the
JAX package's on the CPU.

- Tasks 5 and 6 on tests/test_preprocess.py's scene (48², 3 frames):
  bc.jpg, gt_imgs/*.jpg and torso_imgs/*.png equal to JAX's byte for byte
  (numpy and OpenCV in both).
- Task 9 on the same scene, its parameters from the call, from
  track_params.npz and from track_params.pt: transforms_*.json with JAX's
  structure, focal, centre and frame ids, and the rotations computed in
  float32 and only then widened, as in JAX (every rotation entry a
  float32 value). PyTorch's float32 sin and cos differ from XLA's by an
  ulp at a few percent of the angles, so the matrices are held within
  1e-6 and not byte for byte.
- Task 4 with the TorchScript parsers (a colour-dominance module scripted
  here, and scripts/get_parsing_model.py's exported BiSeNet at random
  weights): the label maps and the PNGs equal JAX's.
- Task 2 under a stand-in `transformers` (a fixed-seed frame map in place
  of HuBERT and of the CTC model): the feature files equal JAX's.
- run_pipeline / `python -m ...preprocess.process` (main) with --device
  cpu; without a GPU and without --device cpu it raises. Tasks 1 and 3
  refuse without ffmpeg, as in JAX. Task 8 reaches track_video on the
  pipeline's device with JAX's arguments, and the focal search runs the
  reference's nine focals. crop_commands equal JAX's.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import lzzx_nerf_tpu.preprocess as jpre
import lzzx_nerf_tpu.preprocess.crop as jcrop
import lzzx_nerf_tpu.preprocess.parsing as jparse
import lzzx_nerf_tpu.preprocess.process as jproc
import lzzx_nerf_tpu_torch.preprocess as tpre
import lzzx_nerf_tpu_torch.preprocess.crop as tcrop
import lzzx_nerf_tpu_torch.preprocess.parsing as tparse
import lzzx_nerf_tpu_torch.preprocess.process as tproc
from test_preprocess import H, W, scene  # noqa: F401  (fixture)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if os.path.isfile(os.path.join(d, f)):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = fh.read()
    return out


def _twin(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _track_params(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return {"focal": np.asarray([900.0]),
            "euler": rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32),
            "trans": (rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]).astype(
                np.float32)}


def test_tasks_5_6_equal_jax(scene, tmp_path):  # noqa: F811
    port = _twin(scene, tmp_path / "port")
    jpre.extract_background(scene, os.path.join(scene, "ori_imgs"), every=1)
    tpre.extract_background(port, os.path.join(port, "ori_imgs"), every=1)
    jpre.extract_torso_and_gt(scene, os.path.join(scene, "ori_imgs"))
    tpre.extract_torso_and_gt(port, os.path.join(port, "ori_imgs"))
    with open(os.path.join(port, "bc.jpg"), "rb") as a, \
            open(os.path.join(scene, "bc.jpg"), "rb") as b:
        assert a.read() == b.read()
    for sub in ("gt_imgs", "torso_imgs"):
        got = _files(os.path.join(port, sub))
        assert got == _files(os.path.join(scene, sub)) and len(got) == 3


@pytest.mark.parametrize("source", ["call", "npz", "pt"])
def test_task_9_equal_jax(scene, tmp_path, source):  # noqa: F811
    params = _track_params()
    frame_ids = [i for i in range(12) if i != 6]
    rng = np.random.default_rng(1)
    for fid in frame_ids:
        np.savetxt(os.path.join(scene, "ori_imgs", f"{fid}.lms"),
                   rng.uniform(5, 40, (68, 2)))
    port = _twin(scene, tmp_path / "port")
    kw = {}
    if source == "call":
        kw = {"track_params": params}
    elif source == "npz":
        for d in (scene, port):
            np.savez(os.path.join(d, "track_params.npz"), **params)
    else:
        for d in (scene, port):
            torch.save({k: torch.as_tensor(v) for k, v in params.items()},
                       os.path.join(d, "track_params.pt"))
    jpre.save_transforms(scene, os.path.join(scene, "ori_imgs"), **kw)
    tpre.save_transforms(port, os.path.join(port, "ori_imgs"), **kw)
    for split in ("train", "val"):
        name = f"transforms_{split}.json"
        with open(os.path.join(port, name)) as f:
            got = json.load(f)
        with open(os.path.join(scene, name)) as f:
            want = json.load(f)
        mats = [np.asarray(fr.pop("transform_matrix")) for fr in got["frames"]]
        ref = [np.asarray(fr.pop("transform_matrix"))
               for fr in want["frames"]]
        assert got == want, name
        for m, r in zip(mats, ref):
            np.testing.assert_allclose(m, r, rtol=0, atol=1e-6)
            rot = m[:3, :3]
            np.testing.assert_array_equal(rot.astype(np.float32), rot)
    with open(os.path.join(port, "transforms_train.json")) as f:
        train = json.load(f)
    assert [fr["img_id"] for fr in train["frames"]] == frame_ids[:10]


class _ColourSeg(torch.nn.Module):
    """test_preprocess.py's parser: RGB dominance -> classes 1 (skin), 14
    (neck), 16 (cloth), 0 (grey background)."""

    def forward(self, x):
        r, g, b = x[:, 0], x[:, 1], x[:, 2]
        logits = torch.zeros(x.shape[0], 19, x.shape[2], x.shape[3],
                             device=x.device)
        logits[:, 0] = 0.55
        logits[:, 1] = r
        logits[:, 14] = g
        logits[:, 16] = b
        return logits


def _frames(base, n=3):
    import cv2

    for d in ("ori_imgs", "parsing", "gt_imgs", "torso_imgs"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = np.full((H, W, 3), 128, np.uint8)
        img[4:20, 16:32] = (40, 40, 220)
        img[20:26, 18:30] = (40, 220, 40)
        img[26:, 10:38] = (220, 40, 40)
        img = np.clip(img + rng.integers(-20, 20, img.shape), 0,
                      255).astype(np.uint8)
        cv2.imwrite(os.path.join(base, "ori_imgs", f"{i}.jpg"), img)


def test_task_4_and_pipeline_equal_jax(tmp_path, monkeypatch):
    """Task 4 through run_pipeline's entry point (main, --device cpu) with
    the parser named by LZZX_PARSER_TS, then tasks 5 and 6 the same way,
    against the JAX tasks on a copy of the frames."""
    ts = str(tmp_path / "parser.pt")
    torch.jit.script(_ColourSeg()).save(ts)
    monkeypatch.setenv("LZZX_PARSER_TS", ts)
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    _frames(jbase)
    shutil.copytree(jbase, tbase)
    video = "clip.mp4"
    for task in (4, 5, 6):
        tproc.main([os.path.join(tbase, video), "--task", str(task),
                    "--device", "cpu"])
    jpre.extract_semantics(os.path.join(jbase, "ori_imgs"),
                           os.path.join(jbase, "parsing"))
    jpre.extract_background(jbase, os.path.join(jbase, "ori_imgs"))
    jpre.extract_torso_and_gt(jbase, os.path.join(jbase, "ori_imgs"))
    for sub in ("parsing", "gt_imgs", "torso_imgs"):
        got = _files(os.path.join(tbase, sub))
        assert got == _files(os.path.join(jbase, sub)) and len(got) == 3
    assert _files(tbase)["bc.jpg"] == _files(jbase)["bc.jpg"]


def test_bisenet_parser_labels_equal_jax(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from get_parsing_model import export_bisenet

    ts = str(tmp_path / "parser.ts")
    export_bisenet(None, ts, eval_size=64)
    frame = np.random.default_rng(0).integers(0, 255, (48, 40, 3),
                                              dtype=np.uint8)
    tp = tparse.FaceParser(ts_path=ts, device="cpu")
    assert tp.device == torch.device("cpu")
    got = tp.parse(frame)
    want = jparse.FaceParser(ts_path=ts).parse(frame)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    lbl = np.random.default_rng(1).integers(0, 19, (16, 16)).astype(np.int32)
    np.testing.assert_array_equal(tparse.color_code(lbl),
                                  jparse.color_code(lbl))


class _Hubert(torch.nn.Module):
    """A fixed-seed stand-in of HuBERT's [1, T, 1024] hidden states:
    kernel 400 / stride 320 frames of the input, mapped linearly."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(400, 1024, generator=g)
                                    * 0.05)

    @staticmethod
    def from_pretrained(name):
        return _Hubert()

    def forward(self, x):
        frames = x[0].unfold(0, 400, 320)
        return types.SimpleNamespace(last_hidden_state=(frames @ self.w)[None])


class _CTC(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.w = torch.nn.Parameter(torch.randn(320, 44, generator=g) * 0.1)

    @staticmethod
    def from_pretrained(name):
        return _CTC()

    def forward(self, x):
        n = x.shape[1] // 320
        return types.SimpleNamespace(
            logits=(x[0, :n * 320].reshape(n, 320) @ self.w)[None])


class _Processor:
    @staticmethod
    def from_pretrained(name):
        return _Processor()

    def __call__(self, samples, sampling_rate=16000, return_tensors="pt",
                 padding=False):
        x = torch.from_numpy(np.asarray(samples, np.float32))[None]
        return types.SimpleNamespace(input_values=x)


@pytest.mark.parametrize("mode,suffix", [("hubert", "_hu.npy"),
                                         ("esperanto", "_eo.npy")])
def test_task_2_equal_jax(tmp_path, monkeypatch, mode, suffix):
    from scipy.io import wavfile

    fake = types.ModuleType("transformers")
    fake.HubertModel, fake.AutoModelForCTC = _Hubert, _CTC
    fake.Wav2Vec2Processor = fake.AutoProcessor = _Processor
    monkeypatch.setitem(sys.modules, "transformers", fake)
    pcm = np.random.default_rng(2).uniform(-0.5, 0.5, 48000)
    out = {}
    for name, mod, kw in (("jax", jproc, {}),
                          ("port", tproc, {"device": "cpu"})):
        wav = str(tmp_path / f"{name}.wav")
        wavfile.write(wav, 16000, (pcm * 32767).astype(np.int16))
        path = mod.extract_audio_features(wav, mode, **kw)
        assert path == wav.replace(".wav", suffix)
        out[name] = np.load(path)
    assert out["port"].shape == out["jax"].shape and out["port"].size
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_pipeline_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproc.main([str(tmp_path / "clip.mp4"), "--task", "9"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparse.FaceParser(ts_path=__file__)
    # tasks 1 and 3 refuse without ffmpeg, as JAX's do
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for task in (1, 3):
        with pytest.raises(RuntimeError, match="ffmpeg not found"):
            tproc.run_pipeline(str(tmp_path / "clip.mp4"), task,
                               device="cpu")


def test_task_8_takes_the_focal_candidates(tmp_path, monkeypatch):
    """Task 8 calls track_video on the pipeline's device with nothing else
    beyond JAX's arguments, so the focal search runs fit_focal's default
    candidates: the reference's nine, as in JAX."""
    import inspect

    from lzzx_nerf_tpu.preprocess import face_tracking as jft
    from lzzx_nerf_tpu_torch.preprocess import face_tracking as tft

    sig = inspect.signature(tft.track_video).parameters
    calls = []
    monkeypatch.setattr(tft, "track_video",
                        lambda *a, **kw: calls.append(kw))
    tproc.main([str(tmp_path / "clip.mp4"), "--task", "8", "--device",
                "cpu"])
    assert calls == [{"device": torch.device("cpu"), "log": calls[0]["log"]}]
    assert [n for n in sig if n not in ("device", "log")] == list(
        inspect.signature(jft.track_video).parameters)
    focals = inspect.signature(tft.fit_focal).parameters["focal_range"]
    want = inspect.signature(jft.fit_focal).parameters["focal_range"]
    assert list(focals.default) == list(want.default) == list(
        range(600, 1500, 100))


def test_crop_commands_equal_jax():
    for bc in (None, "plate.jpg"):
        assert (tcrop.crop_commands("in/v.mp4", 10, 20, 256, 320, bc)
                == jcrop.crop_commands("in/v.mp4", 10, 20, 256, 320, bc))
    with pytest.raises(ValueError, match="even"):
        tcrop.run_crop_tool("v.mp4", 0, 0, 255, 256)
