"""The port's whole training recipe on the CPU at a tiny size (48², grid
32, 4 frames, a few steps per stage): the entry point writes
production_state.pkl, the port's ServingSession serves it, and the JAX
package loads the same file and renders the same pose; --resume continues
the head stage from ckpt_head.pkl.

Tolerances: counters (n_active, n_winmax, n_stage2, n_real, n_short,
n_long) and march masks equal; the image within 2e-4 absolute
(tests/test_torch_render.py's: float32 in both, MLP sums in another
order); a resumed run equals the uninterrupted one exactly (the same
float operations in the same order on one CPU thread)."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models import TorsoField as JTorso
from lzzx_nerf_tpu.models.nerf import make_fused_apply as j_fused_apply
from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.render import OccupancyState as JOcc
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import build_torso_plan as j_torso_plan
from lzzx_nerf_tpu.render import render_rays_compact_blocks as j_render
from lzzx_nerf_tpu.render import run_torso_compact as j_torso
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu.utils.rays import get_bg_coords as j_bg_coords
from lzzx_nerf_tpu_torch.serving import ServingSession
from lzzx_nerf_tpu_torch.serving.state_io import (TORSO_LEAF_PATHS,
                                                  flatten_paths)
from lzzx_nerf_tpu_torch.tools import train_production
from lzzx_nerf_tpu_torch.train import lpips as tlp
from test_torch_bucket import jax_march_masks
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

IMG_ATOL = 2e-4
# a stage-2 budget the session caps at its ray budget (no stage-2 escape:
# the JAX session has none)
NO_STAGE2_ESCAPE = 1 << 30
COUNTERS = ("n_active", "n_winmax", "n_stage2", "n_real", "n_short",
            "n_long")
TINY = ["--device", "cpu", "--res", "48", "--grid", "32", "--frames", "4",
        "--num-rays", "2048", "--head-iters", "40", "--warmup", "20",
        "--eval-every", "20", "--eval-res", "32", "--log-every", "10",
        "--lips-iters", "4", "--lips-pad", "32", "--torso-iters", "20"]


def _nest(paths, leaves):
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(leaf)
    return tree


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """One tiny run of the whole recipe, with no LPIPS npz to be found (the
    fixed-seed backbone)."""
    ws = tmp_path_factory.mktemp("recipe")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LZZX_LPIPS_NPZ", raising=False)
        mp.setattr(tlp, "DEFAULT_WEIGHTS", str(ws / "absent.npz"))
        assert train_production.main(TINY + ["--workspace", str(ws)]) == 0
    lines = [json.loads(x) for x in open(ws / "metrics.jsonl")]
    with open(ws / "production_state.pkl", "rb") as f:
        st = pickle.load(f)
    return dict(ws=ws, lines=lines, state=st)


def test_recipe_runs_every_stage(recipe):
    """The JAX script's events in its order, the four files, the state
    file's keys and meta, and the torso stage's shipped parameters and
    grid (its one eval is the best)."""
    ws, lines, st = recipe["ws"], recipe["lines"], recipe["state"]
    got = [(x["event"], x.get("stage")) for x in lines]
    assert got == ([("start", "head")] + [("log", "head")] * 2
                   + [("eval", "head")] + [("log", "head")] * 2
                   + [("eval", "head"), ("stage_done", "head"),
                      ("start", "lips"), ("log", "lips"), ("eval", "lips"),
                      ("stage_done", "lips"), ("start", "torso"),
                      ("eval", "torso"), ("stage_done", "torso"),
                      ("best_torso", None), ("eval_final", "head"),
                      ("done", None)])
    ev = {(x["event"], x.get("stage")): x for x in lines}
    assert ev[("start", "lips")]["lpips"].startswith("rand-feat")
    assert ev[("eval_final", "head")]["lpips_weights"] == "rand-feat"
    assert ev[("eval_final", "head")]["res"] == 48
    assert np.isfinite(ev[("eval_final", "head")]["lpips"])
    assert all(x["grad_notfinite"] == 0 for x in lines if "loss" in x)
    assert sorted(os.listdir(ws)) == ["ckpt_head.pkl", "ckpt_torso.pkl",
                                      "metrics.jsonl",
                                      "production_state.pkl"]
    assert set(st) == {"head_ema", "torso_leaves", "occ", "meta"}
    meta = st["meta"]
    assert set(meta) == {"res", "grid", "frames", "audio_dim", "aabb", "dt",
                         "intrinsics", "poses", "head_iters", "torso_iters",
                         "lips_iters", "final_psnr"}
    assert (meta["res"], meta["grid"], meta["frames"], meta["head_iters"],
            meta["lips_iters"], meta["torso_iters"]) == (48, 32, 4, 40, 4,
                                                          20)
    assert meta["poses"].shape == (4, 4, 4)
    assert meta["final_psnr"] == pytest.approx(
        ev[("eval_final", "head")]["psnr"], abs=0.01)
    with open(ws / "ckpt_torso.pkl", "rb") as f:
        ck = pickle.load(f)
    assert ck["it"] == 20 and int(ck["state"]["step"]) == 20
    flat = flatten_paths(ck["state"]["params"]["params"])
    for path, leaf in zip(TORSO_LEAF_PATHS, st["torso_leaves"]):
        np.testing.assert_array_equal(leaf, flat[path], err_msg=path)
    occ = st["occ"]
    assert (occ["density_grid_torso"] > 0).any()
    np.testing.assert_array_equal(occ["density_grid_torso"],
                                  ck["occ"]["density_grid_torso"])
    # the EMA moves every 1,000 steps: after 40 + 4 steps it is the init
    with open(ws / "ckpt_head.pkl", "rb") as f:
        hk = pickle.load(f)
    for path, a in flatten_paths(st["head_ema"]).items():
        np.testing.assert_array_equal(
            a, flatten_paths(hk["state"]["ema_params"])[path])


def test_port_written_state_serves_like_jax(recipe):
    """The port's session serves the port-written state (one chunk of two
    frames), and the JAX package, which loads the same pickle (the torso
    tree nested from TORSO_LEAF_PATHS: the port writes no treedef),
    renders pose 0 with the session's plan: counters and march masks
    equal, the image within 2e-4."""
    path = str(recipe["ws"] / "production_state.pkl")
    sess = ServingSession(path, device="cpu", chunk=2,
                          stage2_budget=NO_STAGE2_ESCAPE, log=lambda m: None)
    rng = np.random.default_rng(3)
    auds = rng.standard_normal((2, 8, 16, 29)).astype(np.float32)
    out = sess.render(auds, [0.2, 0.3])
    H = W = sess.H
    assert H == 48 and len(out["frames"]) == 2
    assert all(f.shape == (H * W * 3 // 2,) for f in out["frames"])
    eye = np.float32([0.25])
    with torch.no_grad():
        enc = sess.field.encode_audio(torch.from_numpy(auds[0]))
        t = sess.render_frame(0, enc, torch.from_numpy(eye))

    with open(path, "rb") as f:
        st = pickle.load(f)
    meta = st["meta"]
    kw = dict(bound=1.0, cascade=1, grid_size=int(meta["grid"]),
              max_steps=16, dt=float(meta["dt"]),
              num_cand=sess.settings.num_cand, aabb=tuple(meta["aabb"]))
    jset = JRS(**kw)
    jocc = JOcc(**{k: jnp.asarray(v) for k, v in st["occ"].items()})
    jfield = JField(audio_in_dim=int(meta["audio_dim"]), ind_num=64)
    jparams = {"params": jax.tree.map(jnp.asarray, st["head_ema"])}
    jtorso = JTorso(ind_dim_torso=8, ind_num=64)
    jtp = {"params": _nest(TORSO_LEAF_PATHS, st["torso_leaves"])}
    jtables = jm2.build_inference_tables(jocc.occ, 1.0,
                                         variants=("nb5w", "dil"))
    intr = tuple(float(v) for v in meta["intrinsics"])
    pose = np.asarray(meta["poses"][0], np.float32)
    plan = dict(budget=sess.budget, window_candidates=sess.k2,
                stage_split=8, stage2_budget=sess.stage2_budget,
                march_bucket=sess.bucket, eval_budget=sess.eval_budget)
    jplan = j_torso_plan(jset, jocc, j_bg_coords(H, W)[0])
    tpk = jtorso.apply(jtp, method="bake_table")

    @jax.jit
    def frame(params, packed, tp, auds, pose):
        bg = j_torso(lambda p, *a, **k: jtorso.apply(p, *a, packed=tpk, **k),
                     tp, jplan, pose,
                     tp["params"]["individual_codes_torso"][0],
                     jnp.ones((H * W, 3)))
        rays = j_get_rays(pose[None], intr, H, W, N=-1)
        return j_render(
            j_fused_apply(jfield, packed, use_kernel=False), params, jset,
            jocc, rays["rays_o"][0][0], rays["rays_d"][0], H, W,
            jfield.apply(params, auds, method="encode_audio"),
            params["params"]["individual_codes"][0], jnp.asarray(eye), bg,
            tables=jtables, march_group=2, march_variant="nb5w",
            march_prepass=True, **plan)

    j = jax.tree.map(np.asarray, frame(
        jparams, jfield.apply(jparams, method="bake_tables",
                              dtype=jnp.bfloat16),
        jtp, jnp.asarray(auds[0]), jnp.asarray(pose)))
    for k in COUNTERS:
        assert int(t[k]) == int(j[k]), k
    assert int(j["n_active"]) > 0
    rays = j_get_rays(jnp.asarray(pose)[None], intr, H, W, N=-1)
    jmask = jax_march_masks(jset, jtables, rays["rays_o"][0][0],
                            rays["rays_d"][0], H, W, sess.budget, sess.k2,
                            sess.bucket, sess.eval_budget)
    assert jmask.sum() > 100
    np.testing.assert_array_equal(t["march_mask"].numpy(), jmask)
    np.testing.assert_allclose(t["image"].numpy(),
                               np.clip(j["image"].reshape(H, W, 3), 0, 1),
                               rtol=0, atol=IMG_ATOL)


def test_resume_continues_from_ckpt_head(tmp_path, monkeypatch):
    """A run resumed from the step-6 ckpt_head.pkl of a 12-step head stage
    ends where the uninterrupted run ends: the step count, the optimizer's
    count and second moments, the parameters, the EMA, the occupancy
    state and the last logged loss, equal."""
    saved = {}
    real_save = train_production.save_pickle

    def keep(path, obj):
        if os.path.basename(path) == "ckpt_head.pkl":
            saved.setdefault(obj["it"], pickle.dumps(obj))
        real_save(path, obj)

    monkeypatch.setattr(train_production, "save_pickle", keep)
    args = ["--device", "cpu", "--res", "32", "--grid", "32", "--frames",
            "4", "--num-rays", "1024", "--head-iters", "12", "--warmup",
            "4", "--eval-every", "12", "--eval-res", "24", "--log-every",
            "6", "--ckpt-every", "6", "--lips-iters", "0", "--torso-iters",
            "0"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert train_production.main(args + ["--workspace", str(a)]) == 0
    assert sorted(saved) == [6, 12]
    os.makedirs(b)
    with open(b / "ckpt_head.pkl", "wb") as f:
        f.write(saved[6])
    assert train_production.main(args + ["--workspace", str(b),
                                         "--resume"]) == 0
    lines = {w: [json.loads(x) for x in open(w / "metrics.jsonl")]
             for w in (a, b)}
    res = [x for x in lines[b] if x["event"] == "resume"]
    assert len(res) == 1 and res[0]["it"] == 6
    logs = {w: [x for x in lines[w] if x["event"] == "log"]
            for w in (a, b)}
    assert [x["it"] for x in logs[b]] == [12]
    assert logs[b][-1]["loss"] == logs[a][-1]["loss"]
    with open(a / "ckpt_head.pkl", "rb") as f:
        ca = pickle.load(f)
    with open(b / "ckpt_head.pkl", "rb") as f:
        cb = pickle.load(f)
    assert ca["it"] == cb["it"] == 12
    sa, sb = ca["state"], cb["state"]
    assert int(sa["step"]) == int(sb["step"]) == 12
    assert int(sb["opt_state"]["count"]) == 12
    for key in ("params", "ema_params"):
        fa, fb = flatten_paths(sa[key]), flatten_paths(sb[key])
        for p in fa:
            np.testing.assert_array_equal(fa[p], fb[p], err_msg=p)
    fa = flatten_paths(sa["opt_state"]["nu"])
    fb = flatten_paths(sb["opt_state"]["nu"])
    assert any(np.abs(v).max() > 0 for v in fa.values())
    for p in fa:
        np.testing.assert_array_equal(fa[p], fb[p], err_msg=p)
    for k in ca["occ"]:
        np.testing.assert_array_equal(ca["occ"][k], cb["occ"][k], err_msg=k)
