"""The port's serving slice against the JAX package on the CPU:
render_rays_compact_blocks (nb5wp march with prepass, staged composite,
fused field on bf16 tables) plus the torso pass, on the two-blob fixture
occupancy (data/synthetic.py two_blob_occupancy) at 64² with the trained
weights; the 512² trained-state frame as a slow variant; the session's
no-JAX load and its device default.

Tolerances: counters (admitted rays, window span, stage-2 survivors) and
sample masks are equal. Images agree to 2e-4 absolute: float32 in both,
but the MLP sums run in another order and the composite's exp/cumprod
amplify that by the density; 2e-4 is under a twentieth of one 8-bit
level."""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.data.synthetic import two_blob_occupancy
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models import TorsoField as JTorso
from lzzx_nerf_tpu.models.nerf import make_fused_apply as j_fused_apply
from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.ops.ray import near_far_from_aabb as j_nearfar
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import build_torso_plan as j_torso_plan
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render import render_rays_compact_blocks as j_render
from lzzx_nerf_tpu.render import run_torso_compact as j_torso
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu.utils import rgb_to_yuv420 as j_yuv
from lzzx_nerf_tpu.utils.rays import get_bg_coords as j_bg_coords
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.models import TorsoField as TTorso
from lzzx_nerf_tpu_torch.models import make_fused_apply as t_fused_apply
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.render import RenderSettings as TRS
from lzzx_nerf_tpu_torch.render import OccupancyState as TOcc
from lzzx_nerf_tpu_torch.render import build_torso_plan as t_torso_plan
from lzzx_nerf_tpu_torch.render import render_rays_compact_blocks as t_render
from lzzx_nerf_tpu_torch.render import run_torso_compact as t_torso
from lzzx_nerf_tpu_torch.serving.state_io import (load_trained_state,
                                                  params_from_jax)
from lzzx_nerf_tpu_torch.utils import get_bg_coords as t_bg_coords
from lzzx_nerf_tpu_torch.utils import get_rays as t_get_rays
from lzzx_nerf_tpu_torch.utils import rgb_to_yuv420 as t_yuv
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(REPO, "trained", "production_state.pkl")
IMG_ATOL = 2e-4

H = W = 64
GRID = 32
S = 16
SPLIT = 8
BUDGET = H * W
STAGE2 = 1024


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def slice64():
    """One 64² frame rendered by both packages from the same inputs
    (computed once: one JAX compile for the module)."""
    with open(STATE, "rb") as f:
        jst = pickle.load(f)
    st = load_trained_state(STATE)
    meta = st["meta"]
    dt = 2 * 3 ** 0.5 / GRID
    aabb = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)
    kw = dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=S, dt=dt,
              num_cand=112, aabb=aabb)
    jset, tset = JRS(**kw), TRS(**kw)

    occ = np.asarray(two_blob_occupancy(GRID))
    torso_grid = np.concatenate([np.zeros((GRID // 2, GRID), np.float32),
                                 np.ones((GRID // 2, GRID), np.float32)])
    jocc = j_init_occ(jset)._replace(
        occ=jnp.asarray(occ), density_grid_torso=jnp.asarray(torso_grid),
        mean_density_torso=jnp.asarray(1.0))
    tocc = TOcc(density_grid=torch.zeros((1, GRID, GRID, GRID)),
                occ=_t(occ), mean_density=torch.zeros(()),
                iter_density=torch.zeros((), dtype=torch.int32),
                density_grid_torso=_t(torso_grid),
                mean_density_torso=torch.tensor(1.0))

    a = 0.15
    pose = np.array([[np.cos(a), 0, np.sin(a), 0.02], [0, 1, 0, 0.01],
                     [-np.sin(a), 0, np.cos(a), -2.5], [0, 0, 0, 1]],
                    np.float32)
    intr = (4.0 * W, 4.0 * W, W / 2, H / 2)
    rng = np.random.default_rng(12)
    auds = rng.standard_normal((8, 16, meta["audio_dim"])).astype(np.float32)
    eye = np.asarray([0.3], np.float32)

    # ---- JAX
    jfield = JField(audio_in_dim=int(meta["audio_dim"]), ind_num=64)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                jst["head_ema"])}
    jtorso = JTorso(ind_dim_torso=8, ind_num=64)
    jtp = jax.tree_util.tree_unflatten(
        jst["torso_treedef"], [jnp.asarray(x) for x in jst["torso_leaves"]])
    jtables = jm2.build_inference_tables(jocc.occ, 1.0,
                                         variants=("nb5w", "dil"))
    k2, _, _ = jm2.resolve_march_plan(
        jset, jtables.z_lo, jtables.z_hi, pose[None], intr, H, W,
        march_group=2, march_variant="nb5wp", measure="block",
        log=lambda m: None)
    jpacked = jfield.apply(jparams, method="bake_tables",
                           dtype=jnp.bfloat16)
    jtpacked = jtorso.apply(jtp, method="bake_table")
    jplan = j_torso_plan(jset, jocc, j_bg_coords(H, W)[0])

    @jax.jit
    def jframe(params, packed, tp, tpk, auds, eye, pose):
        enc_a = jfield.apply(params, auds, method="encode_audio")
        rays = j_get_rays(pose[None], intr, H, W, N=-1)
        bg = jnp.ones((H * W, 3))

        def torso_apply(p, *a, **k):
            return jtorso.apply(p, *a, packed=tpk, **k)

        frame_bg = j_torso(torso_apply, tp, jplan, pose,
                           tp["params"]["individual_codes_torso"][0], bg)
        out = j_render(
            j_fused_apply(jfield, packed, use_kernel=True), params, jset,
            jocc, rays["rays_o"][0][0], rays["rays_d"][0], H, W, enc_a,
            params["params"]["individual_codes"][0], eye, frame_bg,
            budget=BUDGET, window_candidates=k2, tables=jtables,
            stage_split=SPLIT, stage2_budget=STAGE2, march_group=2,
            march_variant="nb5wp", march_prepass=True)
        img = jnp.clip(out["image"].reshape(H, W, 3), 0, 1)
        return dict(image=img, frame_bg=frame_bg, yuv=j_yuv(img),
                    n_active=out["n_active"], n_winmax=out["n_winmax"],
                    n_stage2=out["n_stage2"], wsum=out["weights_sum"])

    jout = jax.tree_util.tree_map(np.asarray, jframe(
        jparams, jpacked, jtp, jtpacked, jnp.asarray(auds),
        jnp.asarray(eye), jnp.asarray(pose)))

    # JAX-side march masks of the same frame (the renderer's own stages)
    rays = j_get_rays(jnp.asarray(pose)[None], intr, H, W, N=-1)
    jmask = _jax_march_masks(jset, jtables, rays["rays_o"][0][0],
                             rays["rays_d"][0], k2)

    # ---- port
    tfield = TField(audio_in_dim=int(meta["audio_dim"]), ind_num=64)
    tfield.load_state_dict(params_from_jax(st["head"]))
    ttorso = TTorso(ind_dim_torso=8, ind_num=64)
    ttorso.load_state_dict(params_from_jax(st["torso"]))
    ttables = tm2.build_inference_tables(tocc.occ, 1.0)
    tk2, _, _ = tm2.resolve_march_plan(
        tset, ttables.z_lo, ttables.z_hi, pose[None], intr, H, W,
        march_group=2, march_variant="nb5wp", measure="block",
        log=lambda m: None)
    enc_a = tfield.encode_audio(_t(auds))
    trays = t_get_rays(_t(pose)[None], intr, H, W)
    tplan = t_torso_plan(tset, tocc, t_bg_coords(H, W)[0])
    tpk = ttorso.bake_table()
    frame_bg = t_torso(lambda x, p, c: ttorso(x, p, c, tpk), tplan,
                       _t(pose), ttorso.individual_codes_torso[0],
                       torch.ones((H * W, 3)))
    tout = t_render(
        t_fused_apply(tfield, tfield.bake_tables(torch.bfloat16), enc_a,
                      tfield.individual_codes[0], _t(eye)),
        tset, trays["rays_o"][0, 0], trays["rays_d"][0], H, W, frame_bg,
        budget=BUDGET, tables=ttables, window_candidates=tk2,
        stage_split=SPLIT, stage2_budget=STAGE2, march_variant="nb5wp")
    img = torch.clamp(tout["image"].reshape(H, W, 3), 0, 1)
    return dict(jax=jout, jmask=jmask, k2=(k2, tk2), port=tout, img=img,
                frame_bg=frame_bg, yuv=t_yuv(img))


def _jax_march_masks(settings, tables, origin, rays_d, K2):
    """The JAX renderer's window -> prepass -> compact -> re-snap -> nb5w
    march stages for one frame: march masks [budget, S] in slot order."""
    aabb = jnp.asarray(settings.aabb, jnp.float32)
    NB = H * W // 4
    db = rays_d.reshape(H // 2, 2, W // 2, 2, 3).transpose(
        0, 2, 1, 3, 4).reshape(NB, 4, 3)
    dc = db.mean(axis=1)
    dc = dc / jnp.linalg.norm(dc, axis=-1, keepdims=True)
    oc = jnp.broadcast_to(origin, dc.shape)
    nb, fb = j_nearfar(oc, dc, aabb, settings.min_near)
    win = jm2.ray_windows(oc, dc, nb, fb, tables.z_lo, tables.z_hi,
                          settings.bound, settings.dt, pad_steps=3.0)
    hit = jm2.prepass_block_hits(oc, dc, win.t_start, win.t_end,
                                 tables.col_dilwords, settings.bound,
                                 settings.dt, K2)
    cs = jm2.compact_rays(win.active & hit, BUDGET // 4)
    rows = jnp.take(jnp.concatenate(
        [db.reshape(NB, 12), win.t_start[:, None], win.t_end[:, None], dc],
        axis=-1), cs.ray_idx, axis=0)
    rd = rows[:, :12].reshape(-1, 3)
    ro = jnp.broadcast_to(origin, rd.shape)
    nr, fr = j_nearfar(ro, rd, aabb, settings.min_near)
    t0b = jnp.repeat(rows[:, 12], 4)
    t_start = jnp.maximum(nr, t0b)
    k0 = jnp.ceil(jnp.maximum(t_start - nr, 0.0) / settings.dt - 1e-4)
    m = jm2.march_rays_window_bitmask_nb_block(
        ro, rd, nr + k0 * settings.dt,
        jnp.minimum(fr, jnp.repeat(rows[:, 13], 4)),
        jnp.repeat(cs.slot_valid, 4), rows[:, 12], rows[:, 14:17],
        tables.col_nb5wmask, settings.bound, settings.dt, K2, S,
        variant="nb5w")
    return np.asarray(m.mask)


def test_slice_counters_equal(slice64):
    j, t = slice64["jax"], slice64["port"]
    assert slice64["k2"][0] == slice64["k2"][1]
    assert int(t["n_active"]) == int(j["n_active"]) > 0
    assert int(t["n_winmax"]) == int(j["n_winmax"])
    assert int(t["n_stage2"]) == int(j["n_stage2"])


def test_slice_sample_masks_equal(slice64):
    jm = slice64["jmask"]
    tm = slice64["port"]["march_mask"].numpy()
    assert jm.sum() > 1000
    np.testing.assert_array_equal(tm, jm)


def test_slice_image_within_tolerance(slice64):
    j = slice64["jax"]
    np.testing.assert_allclose(slice64["frame_bg"].numpy(), j["frame_bg"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(slice64["img"].numpy(), j["image"], rtol=0,
                               atol=IMG_ATOL)
    # the head really rendered (not background only)
    assert (j["wsum"] > 0.5).sum() > 100
    np.testing.assert_array_equal(
        slice64["port"]["weights_sum"].numpy() > 0, j["wsum"] > 0)
    yd = np.abs(slice64["yuv"].numpy().astype(np.int32)
                - j["yuv"].astype(np.int32))
    assert yd.max() <= 1


def test_session_loads_without_jax(tmp_path):
    """A fresh interpreter with jax/jaxlib blocked imports the port, loads
    the trained state and builds a serving session on the CPU; no module
    of JAX or of the JAX package is loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.path.insert(0, {os.path.abspath(REPO)!r})
        import numpy as np
        from lzzx_nerf_tpu_torch.serving import ServingSession
        s = ServingSession({os.path.abspath(STATE)!r}, device="cpu",
                           res=256, poses=np.load({str(tmp_path / "p.npy")!r}),
                           log=lambda m: None)
        out = s.render(np.zeros((1, 8, 16, 29), np.float32), [0.25])
        assert out["frames"][0].shape == (256 * 256 * 3 // 2,)
        bad = [m for m, v in sys.modules.items() if v is not None and (
            m.startswith("jax") or m == "lzzx_nerf_tpu"
            or m.startswith("lzzx_nerf_tpu."))]
        assert not bad, bad
        print("OK", s.k2, s.budget)
    """)
    st = load_trained_state(STATE)
    np.save(tmp_path / "p.npy", st["meta"]["poses"][:2])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK" in r.stdout


def test_port_sources_import_no_jax():
    """No module of the port imports jax, flax, optax or the JAX package
    (the scan does not flag the port's own name, nor prose that starts a
    line with "from optax's")."""
    import re

    root = os.path.join(REPO, "lzzx_nerf_tpu_torch")
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|"
                     r"lzzx_nerf_tpu)(?=[.\s,]|$)", re.M)
    seen = 0
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                seen += 1
                with open(os.path.join(dirpath, fn)) as f:
                    assert not pat.search(f.read()), fn
    assert seen > 10
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pat.search(f.read())


def test_session_device_default_raises_without_gpu(monkeypatch):
    """With no GPU the session raises unless it is given device="cpu"."""
    from lzzx_nerf_tpu_torch.serving import ServingSession
    from lzzx_nerf_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingSession(STATE)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _session128(**kw):
    from lzzx_nerf_tpu_torch.serving import ServingSession

    st = load_trained_state(STATE)
    # the stage-2 budget pinned at the ray budget, which holds every
    # survivor: these cases exercise the other escapes only
    kw = {"stage2_budget": 1 << 30, **kw}
    return ServingSession(STATE, device="cpu", res=128, chunk=2,
                          poses=st["meta"]["poses"][:1], **kw)


@pytest.fixture(scope="module")
def frames128():
    """Six frames of the measured 128² session (pose 0, chunk 2, bucket
    and eval on): the session every rebuild case converges to, unless the
    case fixes a plan of its own."""
    auds = np.random.default_rng(21).standard_normal(
        (6, 8, 16, 29)).astype(np.float32)
    eyes = [0.25 + 0.02 * f for f in range(6)]
    s = _session128(log=lambda m: None)
    return auds, eyes, s, s.render(auds, eyes)


@pytest.mark.parametrize("limit", ["budget", "k2", "eval", "long"])
def test_session_raises_on_overflow(frames128, limit):
    """(Named for the raise it replaced.) A frame that needs more than the
    session's plan holds — admitted rays over the ray budget, a window over
    K2, real rays over the eval budget, long-bucket rays over the long
    budget — no longer raises: as in the JAX session
    (tests/test_serving.py: adaptive budget, K2 and eval escapes), the
    session warns, streams every frame, and rebuilds at the next chunk
    boundary; the frames after the rebuild (chunk 3: frames 4, 5) equal a
    session built with the plan it converged to, and an early frame was
    visibly cut."""
    auds, eyes, ctrl, ref = frames128
    n_long = ref["n_long"][0]
    start = {"budget": dict(budget=1024), "k2": dict(k2=20),
             "eval": dict(eval_budget=256),
             # a short bucket that leaves the long bucket one granule
             "long": dict(march_bucket=(ctrl.bucket[0], ctrl.budget - 256),
                          budget=ctrl.budget)}[limit]
    logs = []
    s = _session128(log=logs.append, **start)
    out = s.render(auds, eyes)
    warn = {"budget": "active rays exceed budget 1024",
            "k2": "march candidates > K2=20",
            "eval": "real-sample rays exceed eval budget 256",
            "long": f"{n_long} long-bucket rays exceed the long budget 256"
            }[limit]
    assert any(warn in m and "rebuilding" in m for m in logs), logs
    assert len(out["frames"]) == 6
    assert sum("rebuild at a chunk boundary" in m for m in logs) == 1
    if limit == "budget":
        assert s.budget >= max(out["n_active"])
    elif limit == "k2":
        assert s.k2 == ctrl.k2 > max(out["n_winmax"])
    elif limit == "eval":
        assert s.eval_budget == ctrl.eval_budget >= max(out["n_real"])
    else:
        assert s.long_budget >= n_long and s.bucket == start["march_bucket"]
    if limit in ("k2", "eval"):
        # the plan it converged to is the measured one
        conv, conv_out = ctrl, ref
    else:
        conv = _session128(log=lambda m: None, budget=s.budget,
                           march_bucket=s.bucket or False)
        conv_out = conv.render(auds, eyes)
    assert (conv.budget, conv.k2, conv.eval_budget, conv.bucket) == (
        s.budget, s.k2, s.eval_budget, s.bucket)
    for f in (4, 5):
        np.testing.assert_array_equal(out["frames"][f], conv_out["frames"][f])
    assert not np.array_equal(out["frames"][0], conv_out["frames"][0])


@pytest.mark.slow
def test_trained_frame_512_matches_jax():
    """The 512² trained-state frame (pose 0) with the session's plan —
    measured over the state's 32 poses, bucket march and eval
    re-compaction on: the port's session against the JAX renderer at the
    same K2, budgets and bucket plan. Counters (n_active, n_winmax,
    n_stage2, n_short, n_long, n_real) and the march masks are equal; the
    image agrees to IMG_ATOL with at most one yuv level."""
    from lzzx_nerf_tpu_torch.serving import ServingSession
    from test_torch_bucket import jax_march_masks

    s = ServingSession(STATE, device="cpu", log=lambda m: None)
    assert s.bucket is not None and 0 < s.eval_budget < s.budget
    rng = np.random.default_rng(0)
    auds = rng.standard_normal((1, 8, 16, 29)).astype(np.float32)
    tout = s.render_frame(0, s.encode_audio(_t(auds[0])),
                          torch.tensor([0.25]))
    with open(STATE, "rb") as f:
        jst = pickle.load(f)
    meta = jst["meta"]
    jset = JRS(bound=1.0, cascade=1, grid_size=128, max_steps=16,
               dt=float(meta["dt"]), num_cand=s.settings.num_cand,
               aabb=tuple(meta["aabb"]))
    jocc = j_init_occ(jset)._replace(
        **{k: jnp.asarray(v) for k, v in jst["occ"].items()})
    jfield = JField(audio_in_dim=29, ind_num=64)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                jst["head_ema"])}
    jtorso = JTorso(ind_dim_torso=8, ind_num=64)
    jtp = jax.tree_util.tree_unflatten(
        jst["torso_treedef"], [jnp.asarray(x) for x in jst["torso_leaves"]])
    jtables = jm2.build_inference_tables(jocc.occ, 1.0,
                                         variants=("nb5w", "dil"))
    tpk = jtorso.apply(jtp, method="bake_table")
    plan = j_torso_plan(jset, jocc, j_bg_coords(512, 512)[0])
    pose = jnp.asarray(np.asarray(meta["poses"][0], np.float32))
    enc_a = jfield.apply(jparams, jnp.asarray(auds[0]),
                         method="encode_audio")
    rays = j_get_rays(pose[None], meta["intrinsics"], 512, 512, N=-1)
    frame_bg = j_torso(lambda p, *a, **k: jtorso.apply(p, *a, packed=tpk,
                                                       **k),
                       jtp, plan, pose,
                       jtp["params"]["individual_codes_torso"][0],
                       jnp.ones((512 * 512, 3)))
    out = j_render(
        j_fused_apply(jfield, jfield.apply(jparams, method="bake_tables",
                                           dtype=jnp.bfloat16)),
        jparams, jset, jocc, rays["rays_o"][0][0], rays["rays_d"][0], 512,
        512, enc_a, jparams["params"]["individual_codes"][0],
        jnp.asarray([0.25]), frame_bg, budget=s.budget,
        window_candidates=s.k2, tables=jtables, stage_split=8,
        stage2_budget=s.stage2_budget, march_group=2, march_variant="nb5w",
        march_prepass=True, march_bucket=s.bucket,
        eval_budget=s.eval_budget)
    for k in ("n_active", "n_winmax", "n_stage2", "n_short", "n_long",
              "n_real"):
        assert int(tout[k]) == int(out[k]), k
    assert int(tout["n_long"]) <= s.long_budget
    assert int(tout["n_real"]) <= s.eval_budget
    jmask = jax_march_masks(jset, jtables, rays["rays_o"][0][0],
                            rays["rays_d"][0], 512, 512, s.budget, s.k2,
                            s.bucket, s.eval_budget)
    np.testing.assert_array_equal(tout["march_mask"].numpy(), jmask)
    img_j = np.clip(np.asarray(out["image"]).reshape(512, 512, 3), 0, 1)
    np.testing.assert_allclose(tout["image"].numpy(), img_j, rtol=0,
                               atol=IMG_ATOL)
    yd = np.abs(tout["yuv"].numpy().astype(np.int32)
                - np.asarray(j_yuv(jnp.asarray(img_j))).astype(np.int32))
    assert yd.max() <= 1
