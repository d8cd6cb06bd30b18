"""The port's short/long bucket march and post-march eval re-compaction
against the JAX package on the CPU: the host planners (bucket_short_budget,
measure_real_blocks_host, measure_bucket_plan), render_rays_compact_blocks
with march_bucket and eval_budget on the two-blob fixture at 64² (the
fixture of tests/test_torch_render.py), and the bucketed / re-compacted
frame against the port's own single-bucket frame.

Tolerances: planner outputs, counters (n_active, n_winmax, n_stage2,
n_short, n_long, n_real) and march masks are equal; images agree to 2e-4
absolute against JAX (float32 in both, MLP sums in another order) with at
most one yuv level. Against the port's single-bucket frame, where nothing
overflows, each ray's samples (lattice steps from its near) and the
counters are equal and the image is bit-identical (the bound allowed
there is 1e-6; equality holds on the CPU)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.data.synthetic import two_blob_occupancy
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models.nerf import make_fused_apply as j_fused_apply
from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.ops.march import MarchResult as JMarch
from lzzx_nerf_tpu.ops.ray import near_far_from_aabb as j_nearfar
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render import render_rays_compact_blocks as j_render
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu.utils import rgb_to_yuv420 as j_yuv
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.models import make_fused_apply as t_fused_apply
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.ops.ray import near_far_from_aabb as t_nearfar
from lzzx_nerf_tpu_torch.render import RenderSettings as TRS
from lzzx_nerf_tpu_torch.render import render_rays_compact_blocks as t_render
from lzzx_nerf_tpu_torch.serving.state_io import (load_trained_state,
                                                  params_from_jax)
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
DT = 2 * 3 ** 0.5 / GRID
AABB = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)
INTR = (4.0 * W, 4.0 * W, W / 2, H / 2)

# (march_bucket, eval_budget) per case. At this pose K2 = 22, the measured
# plan is K2s = 16 with 2,908 short and 360 long rays, and 1,316 rays are
# real: "spill" overflows the short budget, "eval_small" the eval budget.
CASES = {
    "bucket": ((16, 2944), 0),
    "spill": ((16, 1024), 0),
    "eval": (None, 2048),
    "eval_small": (None, 512),
    "bucket_eval": ((16, 2944), 2048),
    "spill_eval_small": ((16, 1024), 512),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose(a=0.15):
    return np.array([[np.cos(a), 0, np.sin(a), 0.02], [0, 1, 0, 0.01],
                     [-np.sin(a), 0, np.cos(a), -2.5], [0, 0, 0, 1]],
                    np.float32)


@pytest.fixture(scope="module")
def scene():
    """Both packages' settings, tables, fields and frame inputs for the
    64² two-blob frame at the trained weights."""
    st = load_trained_state(STATE)
    with open(STATE, "rb") as f:
        jst = pickle.load(f)
    kw = dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=S, dt=DT,
              num_cand=112, aabb=AABB)
    occ = np.asarray(two_blob_occupancy(GRID))
    jset, tset = JRS(**kw), TRS(**kw)
    jocc = j_init_occ(jset)._replace(occ=jnp.asarray(occ))
    jtables = jm2.build_inference_tables(jocc.occ, 1.0,
                                         variants=("nb5w", "dil"))
    ttables = tm2.build_inference_tables(_t(occ), 1.0)
    pose = _pose()
    k2, _, _ = tm2.resolve_march_plan(
        tset, ttables.z_lo, ttables.z_hi, pose[None], INTR, H, W,
        march_group=2, march_variant="nb5wp", measure="block",
        log=lambda m: None)
    rng = np.random.default_rng(12)
    auds = rng.standard_normal((8, 16, 29)).astype(np.float32)
    jfield = JField(audio_in_dim=29, ind_num=64)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                jst["head_ema"])}
    tfield = TField(audio_in_dim=29, ind_num=64)
    tfield.load_state_dict(params_from_jax(st["head"]))
    return dict(jset=jset, tset=tset, occ=occ, jocc=jocc, jtables=jtables,
                ttables=ttables, pose=pose, k2=k2, auds=auds, jfield=jfield,
                jparams=jparams, tfield=tfield,
                jpacked=jfield.apply(jparams, method="bake_tables",
                                     dtype=jnp.bfloat16),
                tpacked=tfield.bake_tables(torch.bfloat16))


def _port_frame(sc, march_bucket, eval_budget, stage2=STAGE2):
    tf = sc["tfield"]
    rays = t_get_rays(_t(sc["pose"])[None], INTR, H, W)
    apply = t_fused_apply(tf, sc["tpacked"], tf.encode_audio(_t(sc["auds"])),
                          tf.individual_codes[0], torch.tensor([0.3]))
    out = t_render(apply, sc["tset"], rays["rays_o"][0, 0],
                   rays["rays_d"][0], H, W, torch.full((H * W, 3), 0.6),
                   budget=BUDGET, tables=sc["ttables"],
                   window_candidates=sc["k2"], stage_split=SPLIT,
                   stage2_budget=stage2, march_bucket=march_bucket,
                   eval_budget=eval_budget)
    out["yuv"] = t_yuv(out["image"].reshape(H, W, 3))
    return out


def _jax_frame(sc, march_bucket, eval_budget):
    jf, jset = sc["jfield"], sc["jset"]

    @jax.jit
    def frame(params, packed, auds, pose):
        rays = j_get_rays(pose[None], INTR, H, W, N=-1)
        out = j_render(
            j_fused_apply(jf, packed, use_kernel=False), params, jset,
            sc["jocc"], rays["rays_o"][0][0], rays["rays_d"][0], H, W,
            jf.apply(params, auds, method="encode_audio"),
            params["params"]["individual_codes"][0], jnp.asarray([0.3]),
            jnp.full((H * W, 3), 0.6), budget=BUDGET,
            window_candidates=sc["k2"], tables=sc["jtables"],
            stage_split=SPLIT, stage2_budget=STAGE2, march_group=2,
            march_variant="nb5w", march_prepass=True,
            march_bucket=march_bucket, eval_budget=eval_budget)
        out["yuv"] = j_yuv(out["image"].reshape(H, W, 3))
        return out

    out = frame(sc["jparams"], sc["jpacked"], jnp.asarray(sc["auds"]),
                jnp.asarray(sc["pose"]))
    out = jax.tree_util.tree_map(np.asarray, out)
    out["march_mask"] = _jax_march_masks(sc, march_bucket, eval_budget)
    return out


def _jax_march_masks(sc, march_bucket, eval_budget):
    rays = j_get_rays(jnp.asarray(sc["pose"])[None], INTR, H, W, N=-1)
    return jax_march_masks(sc["jset"], sc["jtables"], rays["rays_o"][0][0],
                           rays["rays_d"][0], H, W, BUDGET, sc["k2"],
                           march_bucket, eval_budget)


def jax_march_masks(jset, tables, origin, rays_d, H, W, budget, K2,
                    march_bucket, eval_budget):
    """The JAX renderer's window -> prepass spans -> bucket split ->
    compaction -> nb5w march -> re-compaction stages for one frame: the
    masks that reach the eval, in slot order."""
    dt, S = jset.dt, jset.max_steps
    aabb = jnp.asarray(jset.aabb, jnp.float32)
    NB = H * W // 4
    db = rays_d.reshape(H // 2, 2, W // 2, 2, 3).transpose(
        0, 2, 1, 3, 4).reshape(NB, 4, 3)
    dc = db.mean(axis=1)
    dc = dc / jnp.linalg.norm(dc, axis=-1, keepdims=True)
    oc = jnp.broadcast_to(origin, dc.shape)
    nb, fb = j_nearfar(oc, dc, aabb, jset.min_near)
    win = jm2.ray_windows(oc, dc, nb, fb, tables.z_lo, tables.z_hi, 1.0, dt,
                          pad_steps=3.0)
    hit, gf, gl = jm2.prepass_block_spans(oc, dc, win.t_start, win.t_end,
                                          tables.col_dilwords, 1.0, dt, K2)
    active = win.active & hit
    t0, t1 = win.t_start, win.t_end
    if march_bucket:
        t0 = win.t_start + (2.0 * dt) * gf.astype(jnp.float32)
        t1 = jnp.minimum(win.t_end, win.t_start
                         + (2.0 * gl.astype(jnp.float32) + 2.0) * dt)
    cols = jnp.concatenate([db.reshape(NB, 12), t0[:, None], t1[:, None],
                            dc], axis=-1)

    def march(cs, k2):
        rows = jnp.take(cols, cs.ray_idx, axis=0)
        rd = rows[:, :12].reshape(-1, 3)
        ro = jnp.broadcast_to(origin, rd.shape)
        nr, fr = j_nearfar(ro, rd, aabb, jset.min_near)
        t_start = jnp.maximum(nr, jnp.repeat(rows[:, 12], 4))
        k0 = jnp.ceil(jnp.maximum(t_start - nr, 0.0) / dt - 1e-4)
        return jm2.march_rays_window_bitmask_nb_block(
            ro, rd, nr + k0 * dt, jnp.minimum(fr, jnp.repeat(rows[:, 13], 4)),
            jnp.repeat(cs.slot_valid, 4), rows[:, 12], rows[:, 14:17],
            tables.col_nb5wmask, 1.0, dt, k2, S, variant="nb5w")

    if march_bucket:
        k2s, bs = march_bucket
        short = active & (2 * (gl - gf + 1) + 2 <= k2s)
        slotted = short & (jnp.cumsum(short.astype(jnp.int32)) <= bs // 4)
        cs_s = jm2.compact_rays(slotted, bs // 4)
        cs_l = jm2.compact_rays((active & ~short) | (short & ~slotted),
                                (budget - bs) // 4)
        m = JMarch(*(jnp.concatenate([a, b]) for a, b in
                     zip(march(cs_s, k2s), march(cs_l, K2))))
        valid = jnp.concatenate([cs_s.slot_valid, cs_l.slot_valid])
    else:
        cs = jm2.compact_rays(active, budget // 4)
        m = march(cs, K2)
        valid = cs.slot_valid
    mask = m.mask
    if eval_budget and eval_budget < budget:
        realb = mask.reshape(budget // 4, 4 * S).any(axis=1) & valid
        csr = jm2.compact_rays(realb, eval_budget // 4)
        mask = (jnp.take(mask.reshape(budget // 4, 4, S), csr.ray_idx,
                         axis=0).reshape(-1, S)
                & jnp.repeat(csr.slot_valid, 4)[:, None])
    return np.asarray(mask)


_FRAMES = {}


def _frames(sc, case):
    if case not in _FRAMES:
        mb, eb = CASES[case]
        _FRAMES[case] = (_jax_frame(sc, mb, eb), _port_frame(sc, mb, eb))
    return _FRAMES[case]


# ---- host planners ------------------------------------------------------

@pytest.mark.parametrize("n_short,budget,gran", [
    (0, 4096, 256), (2908, 4096, 256), (4000, 4096, 256), (45000, 230400,
                                                           1024),
    (100, 1024, 1024), (5000, 2048, 256)])
def test_bucket_short_budget_matches_jax(n_short, budget, gran):
    assert (tm2.bucket_short_budget(n_short, budget, gran)
            == jm2.bucket_short_budget(n_short, budget, gran))


def _window_inputs(occ, pose, res, intr, dt, grid):
    """Each package's block windows of one frame, as numpy."""
    out = {}
    aabb = np.asarray(AABB, np.float32)
    jz = jm2.column_intervals(jnp.asarray(occ), 1.0)
    jr = j_get_rays(jnp.asarray(pose)[None], intr, res, res, N=-1)
    jo, jd = jr["rays_o"][0][0], jr["rays_d"][0]
    db = jd.reshape(res // 2, 2, res // 2, 2, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, 4, 3)
    dc = db.mean(axis=1)
    dc = dc / jnp.linalg.norm(dc, axis=-1, keepdims=True)
    oc = jnp.broadcast_to(jo, dc.shape)
    nb, fb = j_nearfar(oc, dc, jnp.asarray(aabb), 0.05)
    win = jm2.ray_windows(oc, dc, nb, fb, *jz, 1.0, dt, pad_steps=3.0)
    out["jax"] = [np.asarray(a) for a in (jo, db, win.t_start, win.t_end,
                                          win.active)]
    tz = tm2.column_intervals(_t(occ), 1.0)
    tr = t_get_rays(_t(pose)[None], intr, res, res)
    to = tr["rays_o"][0, 0]
    tdb, tdc = tm2.block_view(tr["rays_d"][0], res, res)
    toc = to.expand(tdc.shape)
    nb, fb = t_nearfar(toc, tdc, _t(aabb), 0.05)
    win = tm2.ray_windows(toc, tdc, nb, fb, *tz, 1.0, dt, pad_steps=3.0)
    out["port"] = [a.numpy() for a in (to, tdb, win.t_start, win.t_end,
                                       win.active)]
    return out


def _trained_scene(res=128):
    st = load_trained_state(STATE)
    m = st["meta"]
    intr = tuple(float(v) * res / float(m["res"]) for v in m["intrinsics"])
    return (np.asarray(st["occ"]["occ"]), np.asarray(m["poses"], np.float32),
            intr, float(m["dt"]), int(m["grid"]))


@pytest.mark.parametrize("where", ["blobs64", "trained128"])
def test_measure_real_blocks_host_matches_jax(scene, where):
    """Each package's host count of real blocks, from its own windows,
    equal; at 64² also equal to the renderer's n_real."""
    if where == "blobs64":
        occ, pose, res, intr, dt, k2 = (scene["occ"], scene["pose"],
                                        H, INTR, DT, scene["k2"])
    else:
        occ, poses, intr, dt, _ = _trained_scene()
        pose, res, k2 = poses[0], 128, 82
    w = _window_inputs(occ, pose, res, intr, dt, occ.shape[1])
    counts = {}
    for pkg, fn in (("jax", jm2.measure_real_blocks_host),
                    ("port", tm2.measure_real_blocks_host)):
        o, db, t0, t1, act = w[pkg]
        counts[pkg] = fn(occ[0], AABB, 0.05, o, db, t0, t1, act, 1.0, dt, k2)
    assert counts["port"] == counts["jax"] > 0
    if where == "blobs64":
        _, port = _frames(scene, "eval")
        assert 4 * counts["port"] == int(port["n_real"])


@pytest.mark.parametrize("where,k2s_override", [
    ("blobs64", 0), ("blobs64", 18), ("trained128", 0), ("trained128", 40)])
def test_measure_bucket_plan_matches_jax(scene, where, k2s_override):
    """(K2s, short, long, admitted) over a trajectory equal to JAX's."""
    if where == "blobs64":
        occ, poses = scene["occ"], np.stack([_pose(a) for a in
                                                   (0.15, 0.05, -0.1)])
        res, intr, k2, tset, jset = H, INTR, scene["k2"], scene["tset"], \
            scene["jset"]
    else:
        occ, allp, intr, dt, grid = _trained_scene()
        poses, res, k2 = allp[:1], 128, 82
        kw = dict(bound=1.0, cascade=1, grid_size=grid, max_steps=S, dt=dt,
                  num_cand=112, aabb=AABB)
        tset, jset = TRS(**kw), JRS(**kw)
    jt = jm2.build_inference_tables(jnp.asarray(occ), 1.0,
                                    variants=("dil",))
    tt = tm2.build_inference_tables(_t(occ), 1.0)
    got_j = jm2.measure_bucket_plan(
        jset, jt.z_lo, jt.z_hi, jt.col_dilwords, poses, intr, res, res, k2,
        k2s_override=k2s_override, log=lambda m: None)
    got_t = tm2.measure_bucket_plan(
        tset, tt.z_lo, tt.z_hi, tt.col_dilwords, poses, intr, res, res, k2,
        k2s_override=k2s_override, log=lambda m: None)
    assert got_t == got_j
    assert got_t[3] > 0 and (got_t[0] == k2s_override or not k2s_override)


@pytest.mark.parametrize("k2s", [17, 14, 22, 30])
def test_k2s_override_validated(scene, k2s):
    """Divergence from JAX: an override that is odd, below max_steps, or
    not below K2 raises in the port; the JAX planner adopts it."""
    args = (scene["ttables"].z_lo, scene["ttables"].z_hi,
            scene["ttables"].col_dilwords, scene["pose"][None], INTR, H, W,
            scene["k2"])
    with pytest.raises(ValueError, match="k2s_override"):
        tm2.measure_bucket_plan(scene["tset"], *args, k2s_override=k2s,
                                log=lambda m: None)
    jt = scene["jtables"]
    got = jm2.measure_bucket_plan(
        scene["jset"], jt.z_lo, jt.z_hi, jt.col_dilwords,
        scene["pose"][None], INTR, H, W, scene["k2"], k2s_override=k2s,
        log=lambda m: None)
    assert got[0] == k2s


# ---- the frame against JAX ----------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_bucket_counters_equal(scene, case):
    j, t = _frames(scene, case)
    keys = ["n_active", "n_winmax", "n_stage2"]
    mb, eb = CASES[case]
    if mb:
        keys += ["n_short", "n_long"]
    if eb:
        keys += ["n_real"]
    for k in keys:
        assert int(t[k]) == int(j[k]), k
    assert set(keys) == {k for k in t if k.startswith("n_")}
    if case == "spill":
        assert int(t["n_short"]) > mb[1]
    if case == "eval_small":
        assert int(t["n_real"]) > eb


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_march_masks_equal(scene, case):
    j, t = _frames(scene, case)
    assert j["march_mask"].sum() > 1000
    np.testing.assert_array_equal(t["march_mask"].numpy(), j["march_mask"])


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_image_within_tolerance(scene, case):
    j, t = _frames(scene, case)
    np.testing.assert_allclose(t["image"].numpy(), j["image"], rtol=0,
                               atol=IMG_ATOL)
    np.testing.assert_array_equal(t["weights_sum"].numpy() > 0,
                                  j["weights_sum"] > 0)
    yd = np.abs(t["yuv"].numpy().astype(np.int32)
                - j["yuv"].astype(np.int32))
    assert yd.max() <= 1


# ---- the frame against the port's single-bucket frame -------------------

def _ray_samples(out, sc):
    """Each ray's marched samples as lattice steps from its own near,
    scattered back to ray order: [H*W/4, 4, S] int64, -1 where none."""
    rays = t_get_rays(_t(sc["pose"])[None], INTR, H, W)
    db, _ = tm2.block_view(rays["rays_d"][0], H, W)
    rd = db.reshape(-1, 3)
    near, _ = t_nearfar(rays["rays_o"][0, :1].expand(rd.shape), rd,
                        _t(np.asarray(AABB, np.float32)), 0.05)
    near = near.reshape(-1, 4)
    dt = sc["tset"].dt
    blk = torch.where(out["slot_valid"], out["slot_block"],
                      torch.full_like(out["slot_block"], -1))
    ts = out["march_ts"].reshape(-1, 4, S)
    mask = out["march_mask"].reshape(-1, 4, S)
    steps = torch.full((H * W // 4, 4, S), -1, dtype=torch.int64)
    for slot in torch.nonzero(blk >= 0)[:, 0].tolist():
        b = int(blk[slot])
        k = torch.round((ts[slot] - dt - near[b][:, None]) / dt).long()
        steps[b] = torch.where(mask[slot], k, -1)
    return steps


@pytest.mark.parametrize("case", ["bucket", "spill", "eval",
                                  "bucket_eval"])
def test_bucketed_frame_equals_single_bucket(scene, case):
    """Where nothing overflows (stage 2 holds every ray), the split and the
    re-compaction are scheduling only: the same samples per ray, the same
    counters, the same image. Of the two outcomes allowed (bit-identical,
    or within 1e-6 where a matmul over another row count rounds
    differently), the first holds on the CPU, and the test asserts it."""
    mb, eb = CASES[case]
    base = _port_frame(scene, None, 0, stage2=BUDGET)
    got = _port_frame(scene, mb, eb, stage2=BUDGET)
    for k in ("n_active", "n_winmax", "n_stage2"):
        assert int(got[k]) == int(base[k])
    if eb:
        assert int(got["n_real"]) <= eb
    torch.testing.assert_close(_ray_samples(got, scene),
                               _ray_samples(base, scene), rtol=0, atol=0)
    assert (_ray_samples(base, scene) >= 0).sum() > 1000
    assert torch.equal(got["image"], base["image"])
    assert torch.equal(got["yuv"], base["yuv"])
