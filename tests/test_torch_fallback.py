"""The port's serving fallbacks against the JAX package on the CPU: the
per-ray exact neighbourhood march (march_rays_window_bitmask_nb and its
3x3 table), render_rays_compact (minimal staged, minimal single-pass,
full outputs), the block renderer's group-1 march and single-pass
composite, the planner's step-down, and the session on the paths they
serve: the 40² toy workspace of tests/test_serving.py (the step-down),
an odd-sided dataset (the rgb24 flip) and bound 2 (cascade 2,
render_rays).

Fixture for the renders: the trained state's head at 64² over the
two-blob occupancy (tests/test_torch_render.py's frame), one JAX compile
for all five renders.

Tolerances: sample sets, masks, counters and plan lines equal; images
within 2e-4 (tests/test_torch_render.py's IMG_ATOL: float32 sums in
another order, amplified by the density); session bytes within one level
(the clipped image x 255 truncated: a pixel a float ulp either side of a
level boundary may differ by one)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.data.synthetic import two_blob_occupancy
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models.nerf import make_fused_apply as j_fused_apply
from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render import render_rays_compact as j_compact
from lzzx_nerf_tpu.render import render_rays_compact_blocks as j_blocks
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.models import make_fused_apply as t_fused_apply
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.ops.ray import near_far_from_aabb as t_nearfar
from lzzx_nerf_tpu_torch.render import RenderSettings as TRS
from lzzx_nerf_tpu_torch.render.renderer import (field_outputs,
                                                 render_rays_compact,
                                                 render_rays_compact_blocks)
from lzzx_nerf_tpu_torch.serving import InferenceSession
from lzzx_nerf_tpu_torch.serving.state_io import (load_trained_state,
                                                  params_from_jax)
from lzzx_nerf_tpu_torch.utils import get_rays as t_get_rays
from test_serving import _make_session_workspace
from test_torch_render import STATE
from test_torch_serving import write_state
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

IMG_ATOL = 2e-4
H = W = 64
GRID = 32
S = 16
SPLIT = 8
K2 = 40
BUDGET = 2048
STAGE2 = 1024
INTR = (4.0 * W, 4.0 * W, W / 2, H / 2)
AABB = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose(a=0.15):
    return np.array([[np.cos(a), 0, np.sin(a), 0.02], [0, 1, 0, 0.01],
                     [-np.sin(a), 0, np.cos(a), -2.5], [0, 0, 0, 1]],
                    np.float32)


def _settings(**kw):
    base = dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=S,
                dt=2 * 3 ** 0.5 / GRID, num_cand=112, aabb=AABB)
    base.update(kw)
    return JRS(**base), TRS(**base)


def test_neighborhood_table_equals_jax():
    occ = np.asarray(two_blob_occupancy(GRID))
    j = np.asarray(jm2.column_bitmasks_neighborhood(jnp.asarray(occ)))
    t = tm2.column_bitmasks_neighborhood(_t(occ)).numpy()
    assert t.shape == j.shape == (GRID * GRID, 9)
    np.testing.assert_array_equal(t.view(np.uint32), j)
    tabs = tm2.build_inference_tables(_t(occ), 1.0, variants=())
    assert tabs.col_nbmask is None and tabs.col_nb5wmask is None
    need = tm2.needed_variant_tables(1, "nb5w")
    got = tm2.ensure_variant_tables(tabs, _t(occ), need)
    np.testing.assert_array_equal(got.col_nbmask.numpy(), t)
    assert tm2.needed_variant_tables(2, "nb5w", prepass=True) == (
        "nb5w", "dil")


def _march_inputs(noise: bool):
    """Compacted per-ray windows of the 64² frame (ray_windows, then the
    first BUDGET active rays), from one set of inputs for both packages."""
    jset, tset = _settings()
    occ = np.asarray(two_blob_occupancy(GRID))
    pose = _pose()
    rays = t_get_rays(_t(pose)[None], INTR, H, W)
    ro, rd = rays["rays_o"][0].contiguous(), rays["rays_d"][0]
    aabb = torch.tensor(AABB)
    nears, fars = t_nearfar(ro, rd, aabb, tset.min_near)
    z_lo, z_hi = tm2.column_intervals(_t(occ), 1.0)
    win = tm2.ray_windows(ro, rd, nears, fars, z_lo, z_hi, 1.0, tset.dt)
    cs = tm2.compact_rays(win.active, BUDGET)
    idx = cs.ray_idx
    out = dict(ro=ro[idx].numpy(), rd=rd[idx].numpy(),
               t0=win.t_start[idx].numpy(), t1=win.t_end[idx].numpy(),
               sv=cs.slot_valid.numpy(), nears=nears[idx].numpy(),
               occ=occ, dt=tset.dt)
    out["noise"] = (np.random.default_rng(4).uniform(0, 1, BUDGET).astype(
        np.float32) if noise else None)
    return out


@pytest.mark.parametrize("noise", [False, True], ids=["lattice", "noisy"])
def test_nb_march_matches_jax_and_window_march(noise):
    """Sample sets, masks and positions of the per-ray exact march equal
    JAX's bit for bit and the port's per-candidate march_rays_window."""
    a = _march_inputs(noise)
    jtab = jm2.column_bitmasks_neighborhood(jnp.asarray(a["occ"]))
    kw = dict(noise=None if a["noise"] is None else jnp.asarray(a["noise"]),
              nears=jnp.asarray(a["nears"]) if noise else None)
    jm = jm2.march_rays_window_bitmask_nb(
        jnp.asarray(a["ro"]), jnp.asarray(a["rd"]), jnp.asarray(a["t0"]),
        jnp.asarray(a["t1"]), jnp.asarray(a["sv"]), jtab, 1.0, a["dt"], K2,
        S, **kw)
    tkw = dict(noise=None if a["noise"] is None else _t(a["noise"]),
               nears=_t(a["nears"]) if noise else None)
    targs = (_t(a["ro"]), _t(a["rd"]), _t(a["t0"]), _t(a["t1"]),
             _t(a["sv"]))
    tm = tm2.march_rays_window_bitmask_nb(
        *targs, tm2.column_bitmasks_neighborhood(_t(a["occ"])), 1.0,
        a["dt"], K2, S, **tkw)
    assert int(np.asarray(jm.mask).sum()) > 2000
    for name in ("mask", "ts", "deltas", "xyzs"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    tw = tm2.march_rays_window(*targs, _t(a["occ"]), 1.0, a["dt"], K2, S,
                               **tkw)
    for name in ("mask", "ts", "xyzs"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      getattr(tw, name).numpy(), name)


def test_nb_march_refuses_drift_beyond_its_neighbourhood():
    a = _march_inputs(False)
    tab = tm2.column_bitmasks_neighborhood(_t(a["occ"]))
    args = (_t(a["ro"]), _t(a["rd"]), _t(a["t0"]), _t(a["t1"]),
            _t(a["sv"]), tab, 1.0, 3.0 * a["dt"], K2, S)
    with pytest.raises(ValueError, match="drift"):
        tm2.march_rays_window_bitmask_nb(*args)
    with pytest.raises(ValueError, match="drift"):
        jm2.march_rays_window_bitmask_nb(
            *(jnp.asarray(x.numpy()) for x in args[:5]),
            jm2.column_bitmasks_neighborhood(jnp.asarray(a["occ"])),
            *args[6:])


# the five renders of the fixture: (name, renderer, kwargs)
RENDERS = {
    "compact staged": ("compact", dict(minimal=True, stage_split=SPLIT,
                                       stage2_budget=STAGE2)),
    "compact single-pass": ("compact", dict(minimal=True)),
    "compact full": ("compact", dict(minimal=False)),
    "blocks group 1": ("blocks", dict(march_group=1, stage_split=SPLIT,
                                      stage2_budget=STAGE2)),
    "blocks single-pass": ("blocks", dict(march_group=2, stage_split=0)),
}
COUNTERS = ("n_active", "n_winmax", "n_stage2")
MAPS = ("depth", "ambient_aud", "ambient_eye", "uncertainty")


@pytest.fixture(scope="module")
def renders():
    """RENDERS through both packages, one JAX compile for all."""
    st = load_trained_state(STATE)
    jset, tset = _settings()
    occ = np.asarray(two_blob_occupancy(GRID))
    jocc = j_init_occ(jset)._replace(occ=jnp.asarray(occ))
    pose = _pose()
    rng = np.random.default_rng(12)
    auds = rng.standard_normal((8, 16, 29)).astype(np.float32)
    eye = np.asarray([0.3], np.float32)
    bg = rng.uniform(0, 1, (H * W, 3)).astype(np.float32)

    jfield = JField(audio_in_dim=29, ind_num=64)
    jparams = {"params": jax.tree.map(jnp.asarray, st["head"])}
    jtables = jm2.build_inference_tables(jocc.occ, 1.0,
                                         variants=("nb5w", "dil"))
    jpacked = jfield.apply(jparams, method="bake_tables",
                           dtype=jnp.bfloat16)

    @jax.jit
    def jframe(params, packed, auds, eye, pose, bg):
        enc_a = jfield.apply(params, auds, method="encode_audio")
        rays = j_get_rays(pose[None], INTR, H, W, N=-1)
        ro, rd = rays["rays_o"][0], rays["rays_d"][0]
        apply = j_fused_apply(jfield, packed, use_kernel=True)
        code = params["params"]["individual_codes"][0]
        out = {}
        for name, (kind, kw) in RENDERS.items():
            if kind == "compact":
                out[name] = j_compact(
                    apply, params, jset, jocc, ro, rd, enc_a, code, eye, bg,
                    budget=BUDGET, window_candidates=K2, tables=jtables,
                    **kw)
            else:
                out[name] = j_blocks(
                    apply, params, jset, jocc, ro[0], rd, H, W, enc_a, code,
                    eye, bg, budget=BUDGET, window_candidates=K2,
                    tables=jtables, stage2_budget=kw.get(
                        "stage2_budget", 0), march_variant="nb5wp",
                    march_prepass=True, march_group=kw["march_group"],
                    stage_split=kw["stage_split"])
        return out

    jout = jax.tree.map(np.asarray, jframe(
        jparams, jpacked, jnp.asarray(auds), jnp.asarray(eye),
        jnp.asarray(pose), jnp.asarray(bg)))

    tfield = TField(audio_in_dim=29, ind_num=64)
    tfield.load_state_dict(params_from_jax(st["head"]))
    tables = tm2.build_inference_tables(_t(occ), 1.0,
                                        variants=("nb5w", "dil", "nb"))
    enc_a = tfield.encode_audio(_t(auds))
    apply = t_fused_apply(tfield, tfield.bake_tables(torch.bfloat16), enc_a,
                          tfield.individual_codes[0], _t(eye))
    rays = t_get_rays(_t(pose)[None], INTR, H, W)
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    tout = {}
    for name, (kind, kw) in RENDERS.items():
        if kind == "compact":
            fn = apply if kw["minimal"] else field_outputs(apply)
            tout[name] = render_rays_compact(
                fn, tset, ro, rd, _t(bg), budget=BUDGET, tables=tables,
                window_candidates=K2, **kw)
        else:
            tout[name] = render_rays_compact_blocks(
                apply, tset, ro[0], rd, H, W, _t(bg), budget=BUDGET,
                tables=tables, window_candidates=K2, **kw)
    return jout, tout


@pytest.mark.parametrize("name", list(RENDERS))
def test_fallback_render_matches_jax(renders, name):
    jout, tout = renders
    j, t = jout[name], tout[name]
    for k in COUNTERS:
        assert (k in t) == (k in j), k
        if k in j:
            assert int(t[k]) == int(j[k]), k
    assert int(j["n_active"]) > 500
    np.testing.assert_allclose(t["image"].numpy(), j["image"], rtol=0,
                               atol=IMG_ATOL)
    np.testing.assert_allclose(t["weights_sum"].numpy(), j["weights_sum"],
                               rtol=0, atol=IMG_ATOL)
    assert (j["weights_sum"] > 0.5).sum() > 100
    for k in MAPS:
        assert (k in t) == (k in j), k
        if k in j:
            np.testing.assert_allclose(t[k].numpy(), j[k], rtol=0,
                                       atol=IMG_ATOL, err_msg=k)


def test_plan_steps_down_like_jax():
    """A wide field of view at 40² exceeds the block march's ±2 drift
    envelope: both planners step down to the per-ray march with the same
    K2 and the same lines; measure="ray" sizes K2 from per-ray windows."""
    jset, tset = _settings(max_steps=8)
    occ = np.asarray(two_blob_occupancy(GRID))
    poses = np.stack([_pose(a) for a in (-0.2, 0.0, 0.2)])
    intr = (1.5 * 40, 1.5 * 40, 20.0, 20.0)
    jl, jh = jm2.column_intervals(jnp.asarray(occ), 1.0)
    tl, th = tm2.column_intervals(_t(occ), 1.0)
    for measure, group in (("block", 2), ("ray", 1), (None, 1)):
        jlog, tlog = [], []
        j = jm2.resolve_march_plan(jset, jl, jh, poses, intr, 40, 40,
                                   march_group=group, march_variant="nb5w",
                                   measure=measure, log=jlog.append)
        t = tm2.resolve_march_plan(tset, tl, th, poses, intr, 40, 40,
                                   march_group=group, march_variant="nb5w",
                                   measure=measure, log=tlog.append)
        assert t == j and tlog == jlog, measure
        assert t[1] == 1
        assert any("per-ray exact" in m for m in tlog) == (group == 2)
    for block in (True, False):
        assert tm2.measured_window_candidates(
            tset, tl, th, poses, intr, 40, 40, block=block) == \
            jm2.measured_window_candidates(jset, jl, jh, poses, intr, 40,
                                           40, block=block)


# the session on each fallback path: (tests/test_serving.py workspace
# arguments, Config overrides, the sink's format)
SESSIONS = {
    "stepdown 40²": (dict(), dict(), "rgb24"),
    "odd 41x40": (dict(H=41, W=40, focal_mult=4.0, blob_occ=True), dict(),
                  "yuv420p"),
    "bound 2": (dict(bound=2.0, max_steps=16), dict(bound=2.0, max_steps=16,
                                                    infer_samples=16),
                "rgb24"),
}
SESSION_BASE = dict(asr_model="deepspeech", grid_size=32, max_steps=8,
                    infer_samples=8, infer_stage_split=8,
                    infer_stage2_frac=1.0, budget_frac=1.0, infer_chunk=2)


class _Sink:
    def __init__(self, fmt):
        self.pix_fmt = fmt
        self.frames = []

    def push(self, b):
        self.frames.append(b)

    def close(self):
        pass


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_serves_like_jax(tmp_path, capsys, name):
    """The JAX session and the port's on one workspace: the same plan
    (K2, march group and variant, prepass) and [INFO] lines, the same sink
    format (an odd frame flips a yuv420p sink to rgb24 in both), frames
    within one level."""
    ws_kw, cfg_kw, fmt = SESSIONS[name]
    data, ws = _make_session_workspace(tmp_path, **ws_kw)
    kw = {**SESSION_BASE, **cfg_kw}
    js = JSession(JConfig(**kw))
    js.load_model(data, ws)
    write_state(js, os.path.join(ws, "production_state.pkl"))
    jlines = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[INFO]")]
    tlines = []
    ts = InferenceSession(Config(**kw), device="cpu", log=tlines.append)
    ts.load_model(data, ws)
    assert (ts.k2, ts.march_plan, ts.budget) == (js.k2, js.march_plan,
                                                 js.budget)
    assert [ln for ln in tlines if ln.startswith("[INFO]")] == jlines
    feats = np.random.default_rng(3).standard_normal(
        (3, 16, 29)).astype(np.float32)
    sinks = []
    for s in (js, ts):
        s.set_audio_features(feats)
        sink = _Sink(fmt)
        s.run(sink)
        sinks.append(sink)
    jsink, tsink = sinks
    assert tsink.pix_fmt == jsink.pix_fmt == (
        "rgb24" if ts.H % 2 or ts.W % 2 else fmt)
    assert len(tsink.frames) == len(jsink.frames) == 3
    for a, b in zip(tsink.frames, jsink.frames):
        a = np.frombuffer(a, np.uint8).astype(int)
        b = np.frombuffer(b, np.uint8).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
    path = {"stepdown 40²": "blocks", "odd 41x40": "compact",
            "bound 2": "full"}[name]
    assert ts.path == path
