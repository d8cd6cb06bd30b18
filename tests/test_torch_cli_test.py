"""The port's --test (cli.run_test) against the JAX CLI's on the CPU,
through a carried checkpoint: the JAX Trainer's checkpoint of
tests/test_serving.py's toy workspace, converted by
state_io.checkpoint_from_jax into the port's checkpoint file, rendered by
both CLIs over the same dataset. Three geometries, one per render path:
the 64² two-blob workspace with focal 4 x W (the group-2 block plan with
the prepass and the bucket march), the 40² wide-field workspace (the
step-down to the per-ray march) and an odd-sided 41x40 frame (the per-ray
compact render).

Tolerances: the PNGs within one level (each the clipped image x 255,
truncated: a pixel a float ulp either side of a level boundary may differ
by one), the plan and overflow lines ([INFO] K2 and march lines, the
[WARN] lines of the frames) equal."""

import os
import pickle
import re

import jax
import numpy as np
import pytest
from PIL import Image

from lzzx_nerf_tpu import cli as jcli
from lzzx_nerf_tpu.data.provider import NeRFDataset as JDataset
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import Trainer as JTrainer
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.serving.state_io import (checkpoint_from_jax,
                                                  checkpoint_path)
from test_serving import _make_session_workspace
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

CASES = {
    "blocks 64²": dict(H=64, W=64, focal_mult=4.0, blob_occ=True),
    "stepdown 40²": dict(),
    "odd 41x40": dict(H=41, W=40, focal_mult=4.0, blob_occ=True),
}
FLAGS = ["--asr_model", "deepspeech", "--grid_size", "32", "--max_steps",
         "8", "--infer_samples", "8", "--test", "1", "--test_train", "1"]
PLAN_LINE = re.compile(
    r"^\[(INFO\] (trajectory|adaptive|block|bucket)|WARN\] frame)")


def _carry(jws: str, data: str, tws: str) -> None:
    """The JAX workspace's newest checkpoint as the port's, in tws."""
    jcfg = jcli.build_config([data, "--workspace", jws] + FLAGS)
    _, occ, _, params = jcli._build_world(jcfg, JDataset(jcfg))
    tx = build_optimizer(jcfg.lr, jcfg.lr_net, jcfg.iters)
    state, occ, ok = JTrainer(jws).load_checkpoint(
        JState.create(params, tx), occ)
    assert ok
    ck = checkpoint_from_jax({
        "state": jax.tree.map(np.asarray, state),
        "occ": {k: np.asarray(v) for k, v in occ._asdict().items()}})
    os.makedirs(os.path.join(tws, "checkpoints"))
    with open(checkpoint_path(os.path.join(tws, "checkpoints"),
                              int(ck["state"]["step"])), "wb") as f:
        pickle.dump(ck, f)


def _plan(ws: str):
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        return [ln for ln in f.read().splitlines() if PLAN_LINE.match(ln)]


@pytest.mark.parametrize("name", list(CASES))
def test_run_test_matches_jax(tmp_path, name):
    data, jws = _make_session_workspace(tmp_path, **CASES[name])
    tws = str(tmp_path / "tws")
    _carry(jws, data, tws)
    jcli.run_test(jcli.build_config([data, "--workspace", jws] + FLAGS))
    cli.run_test(*cli.parse_args([data, "--workspace", tws, "--device",
                                  "cpu"] + FLAGS))
    jpng = sorted(os.listdir(os.path.join(jws, "results")))
    tpng = sorted(os.listdir(os.path.join(tws, "results")))
    assert tpng == jpng and len(tpng) == 6
    for f in tpng:
        a = np.asarray(Image.open(os.path.join(tws, "results", f)), int)
        b = np.asarray(Image.open(os.path.join(jws, "results", f)), int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, f
    jplan, tplan = _plan(jws), _plan(tws)
    assert tplan == jplan
    assert any("K2=" in ln for ln in tplan)
    if name == "stepdown 40²":
        assert any("per-ray exact" in ln for ln in tplan)
