"""Parity of the PyTorch port's leaf ops and occupancy tables
(lzzx_nerf_tpu_torch/ops, utils) with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Float tolerances: 1e-5 relative (2e-6 absolute) — float32 math in both,
differing only in operation order inside fused XLA loops. Integer tables,
masks and bf16 table bytes must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.ops import packed_triplane as jpt
from lzzx_nerf_tpu.ops.composite import composite_rays as j_composite
from lzzx_nerf_tpu.ops.freq import freq_encode as j_freq
from lzzx_nerf_tpu.ops.ray import near_far_from_aabb as j_nearfar
from lzzx_nerf_tpu.ops.sh import sh_encode as j_sh
from lzzx_nerf_tpu.utils import color as jcolor
from lzzx_nerf_tpu.utils import rays as jrays
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.ops import packed_triplane as tpt
from lzzx_nerf_tpu_torch.ops.composite import composite_rays as t_composite
from lzzx_nerf_tpu_torch.ops.freq import freq_encode as t_freq
from lzzx_nerf_tpu_torch.ops.ray import near_far_from_aabb as t_nearfar
from lzzx_nerf_tpu_torch.ops.sh import sh_encode as t_sh
from lzzx_nerf_tpu_torch.utils import color as tcolor
from lzzx_nerf_tpu_torch.utils import rays as trays
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 2e-6
AABB = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _unit(rng, n, zscale=1.0):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) * zscale + 0.5
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pose(rng):
    a = rng.uniform(-0.4, 0.4)
    c, s = np.cos(a), np.sin(a)
    p = np.array([[c, 0, s, 0.05], [0, 1, 0, -0.02], [-s, 0, c, -2.5],
                  [0, 0, 0, 1]], np.float32)
    return p


def _occ(grid, seed=0):
    rng = np.random.default_rng(seed)
    occ = np.zeros((grid, grid, grid), bool)
    x, y, z = np.ogrid[:grid, :grid, :grid]
    for _ in range(10):
        c = rng.integers(3, grid - 3, 3)
        r = rng.integers(2, max(3, grid // 8))
        occ |= ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) < r * r
    return occ[None]


def test_get_rays_and_bg_coords():
    rng = np.random.default_rng(0)
    poses = np.stack([_pose(rng), _pose(rng)])
    intr = (70.0, 72.0, 16.0, 15.0)
    j = jrays.get_rays(jnp.asarray(poses), intr, 24, 32, N=-1)
    t = trays.get_rays(_t(poses), intr, 24, 32)
    _close(t["rays_o"], j["rays_o"])
    _close(t["rays_d"], j["rays_d"])
    _close(trays.get_bg_coords(24, 32), jrays.get_bg_coords(24, 32))
    assert trays.min_corner_dz(poses, intr, 24, 32) == \
        jrays.min_corner_dz(poses, intr, 24, 32)


def test_near_far_from_aabb():
    rng = np.random.default_rng(1)
    o = np.tile(np.array([[0.1, -0.05, -2.5]], np.float32), (512, 1))
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)   # many rays miss
    aabb = np.asarray(AABB, np.float32)
    tn, tf = t_nearfar(_t(o), _t(d), _t(aabb), 0.05)
    jn, jf = j_nearfar(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                       0.05)
    _close(tn, jn)
    _close(tf, jf)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    d = _unit(np.random.default_rng(2), 300)
    _close(t_sh(_t(d), degree), j_sh(jnp.asarray(d), degree))


def test_freq_encode():
    x = np.random.default_rng(3).uniform(-1, 1, (64, 6)).astype(np.float32)
    for deg in (3, 8):
        _close(t_freq(_t(x), deg), j_freq(jnp.asarray(x), deg),
               atol=1e-5)


def test_rgb_to_yuv420_bytes():
    """uint8 output: equal except where a value sits on a rounding
    boundary (float order) — at most one level, on at most 0.1% of
    bytes."""
    img = np.random.default_rng(4).uniform(0, 1, (32, 48, 3)).astype(
        np.float32)
    t = tcolor.rgb_to_yuv420(_t(img)).numpy().astype(np.int32)
    j = np.asarray(jcolor.rgb_to_yuv420(jnp.asarray(img))).astype(np.int32)
    assert t.shape == j.shape
    diff = np.abs(t - j)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_composite_rays():
    rng = np.random.default_rng(5)
    N, S = 200, 16
    sig = rng.uniform(0, 40, (N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    amb = rng.uniform(0, 1, (N, S)).astype(np.float32)
    deltas = np.full((N, S), 0.027, np.float32)
    ts = np.cumsum(deltas, 1).astype(np.float32)
    mask = rng.uniform(size=(N, S)) < 0.7
    deltas = np.where(mask, deltas, 0).astype(np.float32)
    t = t_composite(*map(_t, (sig, rgb, amb, amb, amb, deltas, ts, mask)))
    j = j_composite(*map(jnp.asarray, (sig, rgb, amb, amb, amb, deltas, ts,
                                       mask)))
    for name in ("image", "depth", "weights_sum", "amb_aud_sum"):
        _close(getattr(t, name), getattr(j, name), atol=1e-5)


def _levels(rng, spec):
    return [rng.uniform(-1, 1, (r + 1, r + 1, c)).astype(np.float32)
            for r, c in zip(spec.resolutions, spec.channels)]


@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_bake_and_packed_lookup(table):
    """Baked tables equal the JAX bake (bf16: the same bytes — baked in
    f32, cast once); lookups agree within float32 tolerance, including
    points outside [0, 1] (zeros) and the bf16-upcast rows."""
    rng = np.random.default_rng(6)
    jspec = jpt.DenseTriplaneSpec()
    tspec = tpt.DenseTriplaneSpec()
    lv = _levels(rng, jspec)
    jdt, tdt = ((jnp.float32, torch.float32) if table == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = jpt.bake_packed([jnp.asarray(a) for a in lv], jspec, dtype=jdt)
    tp = tpt.bake_packed([_t(a) for a in lv], tspec, dtype=tdt)
    assert tuple(tp.shape) == jp.shape == (256 * 256, 58)
    if table == "bf16":
        np.testing.assert_array_equal(
            tp.view(torch.int16).numpy(),
            np.asarray(jp).view(np.int16))
    else:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    xy = rng.uniform(-0.05, 1.05, (4000, 2)).astype(np.float32)
    _close(tpt.packed_lookup(tp, _t(xy), tspec),
           jpt.packed_lookup(jp, jnp.asarray(xy), jspec), atol=1e-5)


def test_occupancy_tables():
    """column intervals, the nb5w word table and the dilated prepass words
    equal the JAX tables (uint32 bits held in int32)."""
    occ = _occ(64, seed=7)
    jo = jnp.asarray(occ)
    to = _t(occ)
    jl, jh = jm2.column_intervals(jo, 1.0)
    tl, th = tm2.column_intervals(to, 1.0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(
        tm2.column_bitmasks_neighborhood5_words(to).numpy().view(np.uint32),
        np.asarray(jm2.column_bitmasks_neighborhood5_words(jo)))
    np.testing.assert_array_equal(
        tm2.dilated_occupancy_words(to).numpy().view(np.uint32),
        np.asarray(jm2.dilated_occupancy_words(jo)))


def _block_inputs(occ, H=32, W=32, seed=8):
    rng = np.random.default_rng(seed)
    pose = _pose(rng)
    intr = (W / 0.6, W / 0.6, W / 2, H / 2)
    rays = jrays.get_rays(jnp.asarray(pose)[None], intr, H, W, N=-1)
    rd = np.asarray(rays["rays_d"][0])
    origin = np.asarray(rays["rays_o"][0][0])
    db = rd.reshape(H // 2, 2, W // 2, 2, 3).transpose(0, 2, 1, 3, 4)
    dc = db.reshape(-1, 4, 3).mean(axis=1)
    dc = dc / np.linalg.norm(dc, axis=-1, keepdims=True)
    oc = np.broadcast_to(origin, dc.shape).copy()
    return oc.astype(np.float32), dc.astype(np.float32), rd, origin


def test_ray_windows_prepass_compact():
    """The block-centre window analysis, the prepass hits/spans and the
    compaction agree with JAX: windows within float tolerance, every mask
    and index equal."""
    occ = _occ(64, seed=9)
    dt = 2 * 3 ** 0.5 / 64
    oc, dc, _, _ = _block_inputs(occ, 64, 64)
    aabb = np.asarray(AABB, np.float32)
    jn, jf = j_nearfar(jnp.asarray(oc), jnp.asarray(dc), jnp.asarray(aabb),
                       0.05)
    jl, jh = jm2.column_intervals(jnp.asarray(occ), 1.0)
    jw = jm2.ray_windows(jnp.asarray(oc), jnp.asarray(dc), jn, jf, jl, jh,
                         1.0, dt, pad_steps=3.0)
    tn, tf = t_nearfar(_t(oc), _t(dc), _t(aabb), 0.05)
    tl, th = tm2.column_intervals(_t(occ), 1.0)
    tw = tm2.ray_windows(_t(oc), _t(dc), tn, tf, tl, th, 1.0, dt,
                         pad_steps=3.0)
    np.testing.assert_array_equal(tw.active.numpy(), np.asarray(jw.active))
    act = np.asarray(jw.active)
    assert act.sum() > 50
    _close(tw.t_start[_t(act)], np.asarray(jw.t_start)[act])
    _close(tw.t_end[_t(act)], np.asarray(jw.t_end)[act])

    K2 = 40
    jd = jm2.dilated_occupancy_words(jnp.asarray(occ))
    td = tm2.dilated_occupancy_words(_t(occ))
    jhit, jg0, jg1 = jm2.prepass_block_spans(
        jnp.asarray(oc), jnp.asarray(dc), jw.t_start, jw.t_end, jd, 1.0, dt,
        K2)
    thit, tg0, tg1 = tm2.prepass_block_spans(
        _t(oc), _t(dc), tw.t_start, tw.t_end, td, 1.0, dt, K2)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tg0.numpy()[act], np.asarray(jg0)[act])
    np.testing.assert_array_equal(tg1.numpy()[act], np.asarray(jg1)[act])
    np.testing.assert_array_equal(
        tm2.prepass_block_hits(_t(oc), _t(dc), tw.t_start, tw.t_end, td,
                               1.0, dt, K2).numpy(), np.asarray(jhit))

    admitted = act & np.asarray(jhit)
    for budget in (int(admitted.sum()) + 7, int(admitted.sum()) // 2):
        jc = jm2.compact_rays(jnp.asarray(admitted), budget)
        tc = tm2.compact_rays(_t(admitted), budget)
        np.testing.assert_array_equal(tc.ray_idx.numpy(),
                                      np.asarray(jc.ray_idx))
        np.testing.assert_array_equal(tc.slot_valid.numpy(),
                                      np.asarray(jc.slot_valid))
        assert int(tc.n_active) == int(jc.n_active)


def test_host_planners():
    """K2 sizing (geometric bound + trajectory measure) and the drift
    envelope agree with the JAX planners."""
    from lzzx_nerf_tpu.render.state import RenderSettings as JRS
    from lzzx_nerf_tpu_torch.render.state import RenderSettings as TRS

    occ = _occ(32, seed=10)
    dt = 2 * 3 ** 0.5 / 32
    kw = dict(bound=1.0, cascade=1, grid_size=32, max_steps=16, dt=dt,
              num_cand=112)
    rng = np.random.default_rng(11)
    poses = np.stack([_pose(rng) for _ in range(3)])
    intr = (64 / 0.6, 64 / 0.6, 32.0, 32.0)
    jl, jh = jm2.column_intervals(jnp.asarray(occ), 1.0)
    tl, th = tm2.column_intervals(_t(occ), 1.0)
    jk = jm2.resolve_march_plan(JRS(**kw), jl, jh, poses, intr, 64, 64,
                                march_group=2, march_variant="nb5wp",
                                measure="block", log=lambda m: None)
    tk = tm2.resolve_march_plan(TRS(**kw), tl, th, poses, intr, 64, 64,
                                march_group=2, march_variant="nb5wp",
                                measure="block", log=lambda m: None)
    assert jk[1:] == (2, "nb5wp") and tk == jk
    assert tm2.window_candidates_for_scene(tl.numpy(), th.numpy(), dt) == \
        jm2.window_candidates_for_scene(np.asarray(jl), np.asarray(jh), dt)
    assert tm2.default_window_candidates(1.0, 32, dt) == \
        jm2.default_window_candidates(1.0, 32, dt)
    geo = (dt, 1.0, 128, 853.3, 4.3, 0.8)
    assert tm2.nb_block_drift_cells(*geo) == jm2.nb_block_drift_cells(*geo)
