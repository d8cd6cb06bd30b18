"""The port's serving session on the CPU at 128² (trained state, pose 0):
the measured plan, the masked smooth-lips carry, the chunk program's
padded tail, and the port bench.

The carry is the JAX session's masked EMA: enc = where(has_prev > 0,
0.35 prev + 0.65 new, new), advanced only for valid frames, so a reset
stream renders what a fresh session renders and the padded tail of a
chunk changes nothing. Frames are compared byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from lzzx_nerf_tpu_torch import bench
from lzzx_nerf_tpu_torch.serving import ServingSession
from lzzx_nerf_tpu_torch.serving.state_io import load_trained_state
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(REPO, "trained", "production_state.pkl")


# a stage-2 budget the session caps at its ray budget, which holds every
# stage-2 survivor: tests of other behaviour render with no stage-2 escape
NO_STAGE2_ESCAPE = 1 << 30


def _session(**kw):
    poses = load_trained_state(STATE)["meta"]["poses"][:1]
    kw = {"chunk": 2, "log": lambda m: None,
          "stage2_budget": NO_STAGE2_ESCAPE, **kw}
    return ServingSession(STATE, device="cpu", res=128, poses=poses, **kw)


def _inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    auds = rng.standard_normal((n, 8, 16, 29)).astype(np.float32)
    return auds, [0.2 + 0.05 * f for f in range(n)]


def test_session_plan_holds_its_frames():
    """The measured plan (bucket on, eval on) holds the frames of its own
    poses: admitted rays, long-bucket rays and real rays within their
    budgets, so no escape fires; the eval budget is the host-measured real
    rays x 1.25 rounded up to the granule; the stage-2 budget is 0.375 of
    the ray budget, in 1024-slot steps (the JAX session's)."""
    logs = []
    s = _session(log=logs.append, stage2_budget=0)
    assert s.bucket is not None and s.bucket[0] >= 16
    assert 0 < s.eval_budget < s.budget
    assert s.long_budget == s.budget - s.bucket[1]
    assert s.stage2_budget == max(1024, int(s.budget * 0.375) // 1024 * 1024)
    auds, eyes = _inputs(2)
    out = s.render(auds, eyes)
    assert max(out["n_active"]) <= s.budget
    assert max(out["n_long"]) <= s.long_budget
    assert 0 < max(out["n_real"]) <= s.eval_budget
    assert s.eval_budget == -(-int(max(out["n_real"]) * 1.25)
                              // s.gran) * s.gran
    # pose 0 overflows the stage-2 budget at 128²: its warning asks for
    # the stage-2 escape's rebuild, which the next render() makes; nothing
    # else warns, and this one-chunk render rebuilds nothing
    assert not [m for m in logs if "[WARN]" in m and "stage-2" not in m]
    assert not [m for m in logs if "rebuild at a chunk boundary" in m]
    assert s.rebuild_pending()
    assert any(m.startswith("plan: K2=") and "eval_budget=" in m
               for m in logs)


def test_stage2_overflow_rebuilds_once():
    """The port's stage-2 escape (the JAX session warns and truncates
    instead): from a stage-2 budget of 256 the session warns, streams every
    frame and rebuilds once at the next chunk boundary with 1.25 x the
    observed survivors in whole granules; the frames after the rebuild
    (chunk 3: frames 4, 5) equal a session built with that stage-2 budget,
    and frame 0 was visibly cut."""
    auds, eyes = _inputs(6)
    logs = []
    s = _session(log=logs.append, stage2_budget=256)
    out = s.render(auds, eyes)
    assert len(out["frames"]) == 6
    assert any("stage-2 survivors exceed the stage-2 budget 256" in m
               and "rebuilding" in m for m in logs), logs
    assert sum("rebuild at a chunk boundary" in m for m in logs) == 1
    first = max(out["n_stage2"][:2])
    assert s.stage2_budget == min(s.budget,
                                  -(-int(first * 1.25) // s.gran) * s.gran)
    assert max(out["n_stage2"]) <= s.stage2_budget
    conv = _session(stage2_budget=s.stage2_budget)
    assert conv.stage2_budget == s.stage2_budget
    conv_out = conv.render(auds, eyes)
    for f in (4, 5):
        np.testing.assert_array_equal(out["frames"][f], conv_out["frames"][f])
    assert not np.array_equal(out["frames"][0], conv_out["frames"][0])


def test_sample_budget_escape_rebuilds_to_exact_frames():
    """Stage-1 sample compaction in the bench session, from 256 sample
    slots: the marched stage-1 samples overflow, the session warns,
    streams every frame and rebuilds at the next chunk boundary with 1.25
    x the observed samples in whole granules (at most the stage-1
    lattice); the frames after the rebuild equal the uncompacted
    session's, frame 0 was cut."""
    auds, eyes = _inputs(6)
    logs = []
    s = _session(log=logs.append, sample_budget=256)
    assert s.sample_budget == 256
    out = s.render(auds, eyes)
    assert len(out["frames"]) == 6
    assert any("marched stage-1 points exceed the sample budget 256" in m
               for m in logs), logs
    first = max(out["n_spts"][:2])
    assert s.sample_budget == min(s._sample_cap,
                                  -(-int(first * 1.25) // s.gran) * s.gran)
    assert max(out["n_spts"][4:]) <= s.sample_budget
    base = _session().render(auds, eyes)
    for f in (4, 5):
        np.testing.assert_array_equal(out["frames"][f], base["frames"][f])
    assert not np.array_equal(out["frames"][0], base["frames"][0])


def test_masked_ema_after_reset_equals_fresh_session():
    auds, eyes = _inputs(3)
    s = _session()
    s.render(auds[::-1].copy(), eyes)
    s.reset_audio()
    again = s.render(auds, eyes)["frames"]
    fresh = _session().render(auds, eyes)["frames"]
    for a, b in zip(again, fresh):
        np.testing.assert_array_equal(a, b)


def test_chunk_tail_does_not_advance_the_carry():
    """Chunk 2 over 3 frames pads its last chunk with a repeat of frame 2
    marked invalid; the frames and the carried code equal chunk 1's."""
    auds, eyes = _inputs(3)
    s2, s1 = _session(chunk=2), _session(chunk=1)
    f2 = s2.render(auds, eyes)["frames"]
    f1 = s1.render(auds, eyes)["frames"]
    assert len(f2) == len(f1) == 3
    for a, b in zip(f2, f1):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(s2._prev_enc, s1._prev_enc)


def test_session_refuses_graph_on_cpu():
    auds, eyes = _inputs(1)
    with pytest.raises(ValueError, match="CUDA"):
        _session().render(auds, eyes, graph=True)


def test_port_bench_prints_one_line(capsys):
    assert bench.main(["--device", "cpu", "--res", "128", "--frames", "2",
                       "--chunk", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "render_fps_128" and line["unit"] == "fps"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 25.0, 3)


def test_port_bench_refuses_bound_with_state():
    """Divergence from bench.py, which drops --state when --bound != 1 and
    measures another scene without a word: the port raises."""
    with pytest.raises(SystemExit, match="bound"):
        bench.main(["--device", "cpu", "--bound", "2.0"])
