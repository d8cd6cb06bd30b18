"""The port's --asr (cli.run_asr_live) on the CPU, under a stand-in
`transformers` module (no weights): its CTC "model" is a fixed-seed
linear map of each 20 ms chunk to 29 logits (50 Hz), so a HF-style id
containing "deepspeech" takes the 29-wide (l, m, r) streaming path.

Fixture: the synthetic oracle as a 32² dataset of 8 frames
(tools/dataset.py, 29-wide deepspeech features) and a workspace holding a
seeded head checkpoint of the port's CLI (grid 32, every cell occupied);
a seeded 16 kHz wav of 2.5 s.

Held: the saved features (--asr_save_feats, <wav>.npy) equal JAX's
StreamingASR.feature_rows over the same wav and stand-in, concatenated;
the rendered frames (a raw rgb24 file: the test hides ffmpeg) byte-equal
to the port's InferenceSession.run() over those features; a workspace
without a checkpoint is refused. That run pins the ray, stage-2 and eval
budgets at the whole frame. At the Config's budgets a fresh session's
rebuild escapes act when a chunk's counters are read, which run_live
does after each chunk and run() one chunk behind: run() renders frames
8-15 truncated as well, run_live rebuilds before them. The second test
holds that divergence (ROADMAP Queue 3 item 8): the same features and
frame count, and byte-equal frames but for exactly 8-15."""

import os
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from lzzx_nerf_tpu.serving.asr import StreamingASR as JStreamingASR
from lzzx_nerf_tpu.serving.asr import wav_chunk_stream as j_wav_chunks
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
from lzzx_nerf_tpu_torch.serving import InferenceSession
from lzzx_nerf_tpu_torch.serving.streaming import RawFileSink
from lzzx_nerf_tpu_torch.tools.dataset import write_synthetic_dataset
from lzzx_nerf_tpu_torch.train import HeadOptimizer, TrainState
from lzzx_nerf_tpu_torch.train.trainer import Trainer
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

MODEL_ID = "standin/deepspeech-ctc"
CONFIG_FLAGS = ["--asr_model", MODEL_ID, "--grid_size", "32", "--device",
                "cpu"]
FLAGS = CONFIG_FLAGS + ["--budget_frac", "1.0", "--infer_stage2_frac", "1.0",
                        "--infer_eval_frac", "1.0"]


class _Processor:
    @staticmethod
    def from_pretrained(name):
        return _Processor()

    def __call__(self, samples, sampling_rate, return_tensors, padding):
        x = torch.from_numpy(np.asarray(samples, np.float32))[None]
        return types.SimpleNamespace(input_values=x)


class _CTC(torch.nn.Module):
    """29 logits per 320 samples, from a fixed-seed linear map."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(320, 29, generator=g) * 0.1)

    @staticmethod
    def from_pretrained(name):
        return _CTC()

    def forward(self, x):
        n = x.shape[1] // 320
        return types.SimpleNamespace(
            logits=(x[0, :n * 320].reshape(n, 320) @ self.w)[None])


@pytest.fixture()
def standin(monkeypatch):
    fake = types.ModuleType("transformers")
    fake.AutoProcessor = _Processor
    fake.AutoModelForCTC = _CTC
    monkeypatch.setitem(__import__("sys").modules, "transformers", fake)
    # the raw sink, whatever the machine has
    monkeypatch.setattr(cli.shutil, "which", lambda name: None)


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    root = tmp_path_factory.mktemp("asr")
    data = write_synthetic_dataset(str(root / "oracle"), res=32, frames=8,
                                   val=2)["data"]
    ws = str(root / "trial")
    cfg = Config(path=data, workspace=ws, asr_model="deepspeech",
                 grid_size=32)
    ds = NeRFDataset(cfg)
    _, occ, field = cli._build_world(cfg, ds, torch.device("cpu"))
    occ = occ._replace(occ=torch.ones_like(occ.occ))
    Trainer(ws).save_checkpoint(TrainState.create(
        field, HeadOptimizer(field.named_parameters())), occ)
    with open(os.path.join(ws, "opt.txt"), "w") as f:
        f.write(cfg.to_json(indent=None) + "\n")
    pcm = np.random.default_rng(4).uniform(-0.5, 0.5, 40000)
    wav = str(root / "speech.wav")
    wavfile.write(wav, 16000, (pcm * 32767).astype(np.int16))
    return dict(root=root, data=data, ws=ws, wav=wav)


def test_asr_live_matches_jax_features_and_run(identity, standin):
    w = identity
    argv = [w["data"], "--workspace", w["ws"], "--asr", "1", "--asr_wav",
            w["wav"], "--asr_save_feats", "1"] + FLAGS
    got = cli.run_asr_live(*cli.parse_args(argv))
    feats = np.load(os.path.splitext(w["wav"])[0] + ".npy")
    assert got["feats"] == os.path.splitext(w["wav"])[0] + ".npy"

    # JAX's streaming path over the same wav and stand-in
    jasr = JStreamingASR(29, asr_model=MODEL_ID, save_feats=True)
    rows = list(jasr.feature_rows(j_wav_chunks(w["wav"])))
    want = np.concatenate(rows, axis=0)
    assert feats.shape == want.shape == (got["frames"], 16, 29)
    np.testing.assert_array_equal(feats, want)

    # the frames: byte-equal to run() over the saved features
    assert got["out"] == os.path.join(w["ws"], "results", "asr_live.raw")
    with open(got["out"], "rb") as f:
        live = f.read()
    sess = InferenceSession(cli.build_config(argv).replace(asr=False),
                            device="cpu")
    sess.load_model(w["data"], w["ws"])
    sess.set_audio_features(feats)
    ref = str(w["root"] / "run.raw")
    n, _ = sess.run(RawFileSink(ref))
    with open(ref, "rb") as f:
        offline = f.read()
    assert n == got["frames"] > 0
    assert len(live) == n * sess.H * sess.W * 3
    assert live == offline


def test_asr_live_at_the_configs_budgets(identity, standin):
    w = identity
    argv = [w["data"], "--workspace", w["ws"], "--asr", "1", "--asr_wav",
            w["wav"], "--asr_save_feats", "1"] + CONFIG_FLAGS
    got = cli.run_asr_live(*cli.parse_args(argv))
    feats = np.load(got["feats"])
    jasr = JStreamingASR(29, asr_model=MODEL_ID, save_feats=True)
    np.testing.assert_array_equal(feats, np.concatenate(
        list(jasr.feature_rows(j_wav_chunks(w["wav"]))), axis=0))
    with open(got["out"], "rb") as f:
        live = f.read()
    sess = InferenceSession(cli.build_config(argv).replace(asr=False),
                            device="cpu")
    sess.load_model(w["data"], w["ws"])
    sess.set_audio_features(feats)
    ref = str(w["root"] / "run_config.raw")
    n, _ = sess.run(RawFileSink(ref))
    with open(ref, "rb") as f:
        offline = f.read()
    fb = sess.H * sess.W * 3
    assert n == got["frames"] > 16
    assert len(live) == len(offline) == n * fb
    differ = [i for i in range(n)
              if live[i * fb:(i + 1) * fb] != offline[i * fb:(i + 1) * fb]]
    assert differ == list(range(8, 16))


def test_asr_refuses_a_workspace_without_a_checkpoint(identity, standin):
    w = identity
    with pytest.raises(SystemExit, match="no head checkpoint"):
        cli.run_asr_live(*cli.parse_args(
            [w["data"], "--workspace", str(w["root"] / "empty"), "--asr",
             "1", "--asr_wav", w["wav"]] + FLAGS))


def test_asr_model_names_give_their_widths():
    assert cli.asr_feature_dim(cli.ASR_MODEL_IDS["esperanto"]) == 44
    assert cli.asr_feature_dim("someone/deepspeech-ctc") == 29
    assert cli.asr_feature_dim("facebook/wav2vec2-base-960h") == 32
