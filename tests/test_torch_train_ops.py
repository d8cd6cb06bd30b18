"""The training slice's ops in the port against the JAX package on the CPU:
the synthetic oracle, Morton/packbits/dilation, the full-path and window
marches, the occupancy refresh and the untrained-cell marks; and the
transmittance cut at T_thresh in the serving and the training composite.

Tolerances: frames, occupancy grids, bit tables, masks and counters are
equal; march sample positions within 1e-6 absolute; the refreshed density
grid within 1e-6 relative (its mean, a sum of 32,768 values in another
order, within 1e-5); composites within 1e-6 absolute forward and
1e-5 relative (1e-9 absolute) in their gradients; the processed masks of
the threshold test bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
from lzzx_nerf_tpu.data.synthetic import two_blob_occupancy as j_two_blob
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.ops import march as jm
from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.ops import morton as jmo
from lzzx_nerf_tpu.ops.composite import composite_rays as j_composite
from lzzx_nerf_tpu.ops.ray import near_far_from_aabb as j_nearfar
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render.grid_update import \
    make_density_grid_update as j_refresh_maker
from lzzx_nerf_tpu.render.grid_update import \
    mark_untrained_grid as j_mark
from lzzx_nerf_tpu.render.renderer import \
    _staged_eval_composite as j_staged
from lzzx_nerf_tpu_torch.data import SyntheticTalkingHead as TData
from lzzx_nerf_tpu_torch.data import two_blob_occupancy as t_two_blob
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.ops import march as tm
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.ops import morton as tmo
from lzzx_nerf_tpu_torch.ops.composite import composite_rays as t_composite
from lzzx_nerf_tpu_torch.ops.ray import near_far_from_aabb as t_nearfar
from lzzx_nerf_tpu_torch.render import OccupancyState
from lzzx_nerf_tpu_torch.render import RenderSettings as TRS
from lzzx_nerf_tpu_torch.render import make_density_grid_update
from lzzx_nerf_tpu_torch.render import mark_untrained_grid as t_mark
from lzzx_nerf_tpu_torch.render.renderer import \
    _staged_eval_composite as t_staged
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

GRID = 32
RES = 48
T_THRESH = np.float32(1e-4)
DT = np.float32(2 * np.sqrt(3) / 128)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kw", [dict(num_frames=8, H=RES, W=RES),
                                dict(num_frames=32, H=64, W=64, torso=True)])
def test_synthetic_frames_equal(kw):
    jd, td = JData(**kw), TData(**kw)
    assert jd.intrinsics == td.intrinsics
    for f in (0, 5, kw["num_frames"] - 1):
        a, b = jd.frame(f), td.frame(f)
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("grid", [32, 64, 128])
def test_two_blob_occupancy_equal(grid):
    t = t_two_blob(grid)
    assert t.dtype == torch.bool and t.shape == (1, grid, grid, grid)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_two_blob(grid)))


def test_morton_packbits_dilate_equal():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, (5000, 3)).astype(np.int32)
    codes = tmo.morton3d(_t(coords))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jmo.morton3d(coords)))
    np.testing.assert_array_equal(tmo.morton3d_invert(codes).numpy(), coords)
    np.testing.assert_array_equal(
        tmo.morton3d_invert(codes).numpy(),
        np.asarray(jmo.morton3d_invert(np.asarray(codes.numpy()))))
    grid = rng.uniform(0, 20, (1, 16, 16, 16)).astype(np.float32)
    bits = tmo.packbits(_t(grid), 10.0)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jmo.packbits(grid, 10.0)))
    np.testing.assert_array_equal(tmo.unpack_bitfield(bits).numpy(),
                                  (grid > 10.0).reshape(-1))
    # dilation: a 6-neighbour cross with edge replication; -1 marks pass
    # through the max
    g = rng.uniform(0, 1, (2, 12, 12, 12)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.2] = -1.0
    g[0, 3, 4, 5] = 7.0
    got = tmo.dilate_grid3d(_t(g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmo.dilate_grid3d(g)))
    assert got[0, 4, 4, 4] < 7.0 and got[0, 4, 4, 5] == 7.0


def _rays(n, seed, origin=(0.0, 0.1, -2.5)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32) * [0.3, 0.3, 0.1]
    d[:, 2] += 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32(origin), (n, 3)).astype(np.float32)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("noise,cascade,bound", [(False, 1, 1.0),
                                                 (True, 1, 1.0),
                                                 (True, 2, 2.0)])
def test_march_rays_uniform_equal(noise, cascade, bound):
    """First-S samples of the full-path march: masks equal, positions
    within 1e-6; cascade 2 exercises the mip-level selection."""
    H, S = GRID, 8
    dt = jm.marching_dt(bound, H, S, cascade)
    assert dt == tm.marching_dt(bound, H, S, cascade)
    aabb = np.float32([-bound, -bound / 2, -bound, bound, bound / 2, bound])
    K = jm.num_candidates(aabb, 0.05, dt)
    assert K == tm.num_candidates(aabb, 0.05, dt)
    occ = np.asarray(j_two_blob(H))
    occ = np.concatenate([occ] + [np.roll(occ, 3, axis=1)] * (cascade - 1))
    o, d = _rays(3000, 1, origin=(0.0, 0.1, -2.5 * bound))
    nz = (np.random.default_rng(2).uniform(size=3000).astype(np.float32)
          if noise else None)
    jn, jf = j_nearfar(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                       0.05)
    jr = jm.march_rays_uniform(jnp.asarray(o), jnp.asarray(d), jn, jf,
                               jnp.asarray(occ), bound, dt, K, S,
                               noise=None if nz is None else jnp.asarray(nz))
    tn, tf = t_nearfar(_t(o), _t(d), _t(aabb), 0.05)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    tr = tm.march_rays_uniform(_t(o), _t(d), tn, tf, _t(occ), bound, dt, K,
                               S, noise=None if nz is None else _t(nz))
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    assert 0 < tr.mask.sum() < tr.mask.numel()
    for k in ("xyzs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("noise", [False, True])
def test_march_rays_window_equal(noise):
    """The compacted step's window march on the noisy lattice: equal."""
    H, S = GRID, 8
    dt = 2 * 3 ** 0.5 / H
    aabb = np.float32([-1, -0.5, -1, 1, 0.5, 1])
    occ = np.asarray(j_two_blob(H))
    o, d = _rays(2000, 3)
    nz = np.random.default_rng(4).uniform(size=2000).astype(np.float32)
    jn, jf = j_nearfar(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                       0.05)
    z_lo, z_hi = jm2.column_intervals(jnp.asarray(occ), 1.0)
    win = jm2.ray_windows(jnp.asarray(o), jnp.asarray(d), jn, jf, z_lo, z_hi,
                          1.0, dt)
    cs = jm2.compact_rays(win.active, 1024)
    idx = np.asarray(cs.ray_idx)
    args = [np.asarray(a)[idx] for a in (o, d, win.t_start, win.t_end)]
    sv = np.asarray(cs.slot_valid)
    kw = (dict(noise=nz[idx], nears=np.asarray(jn)[idx]) if noise else {})
    jr = jm2.march_rays_window(*[jnp.asarray(a) for a in args],
                               jnp.asarray(sv), jnp.asarray(occ), 1.0, dt,
                               40, S, **{k: jnp.asarray(v)
                                         for k, v in kw.items()})
    tr = tm2.march_rays_window(*[_t(a) for a in args], _t(sv), _t(occ), 1.0,
                               dt, 40, S, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    assert 0 < tr.mask.sum() < tr.mask.numel()
    for k in ("xyzs", "deltas", "ts"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)), err_msg=k)


@pytest.fixture(scope="module")
def grid_world():
    ds = JData(num_frames=8, H=RES, W=RES)
    jrs = JRS(bound=1.0, cascade=1, grid_size=GRID, max_steps=8,
              dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    trs = TRS(bound=1.0, cascade=1, grid_size=GRID, max_steps=8,
              dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    field = JField(audio_in_dim=ds.audio_dim, ind_num=64)
    b0 = ds.frame(0)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3)) / 3 ** 0.5,
        jnp.asarray(b0["auds"]), jnp.zeros(4), jnp.asarray([0.2]),
        method="init_all")
    poses = np.stack([ds.pose(i) for i in range(8)])
    return ds, jrs, trs, field, params, poses


def test_mark_untrained_grid_equal(grid_world):
    ds, jrs, trs, _, _, poses = grid_world
    j = j_mark(jrs, j_init_occ(jrs), jnp.asarray(poses), ds.intrinsics)
    t = t_mark(trs, _occ_from(j_init_occ(jrs)), _t(poses), ds.intrinsics)
    np.testing.assert_array_equal(t.density_grid.numpy(),
                                  np.asarray(j.density_grid))
    assert (t.density_grid == -1).any() and (t.density_grid == 0).any()


def _occ_from(jocc):
    return OccupancyState(**{k: _t(np.asarray(v))
                             for k, v in jocc._asdict().items()})


def test_density_grid_refresh_equal(grid_world):
    """One head refresh on the JAX refresh's own jitter
    (fold_in(fold_in(rng, step), 0x6772), one split per cascade) from a
    marked grid that already holds densities: occupancy equal, the grid
    within 1e-6 relative."""
    ds, jrs, trs, field, params, poses = grid_world
    jocc = j_mark(jrs, j_init_occ(jrs), jnp.asarray(poses), ds.intrinsics)
    rng0 = np.random.default_rng(7)
    old = np.where(np.asarray(jocc.density_grid) < 0, -1.0,
                   rng0.uniform(0, 2, jocc.density_grid.shape)
                   ).astype(np.float32)
    jocc = jocc._replace(density_grid=jnp.asarray(old))
    b = ds.frame(3)
    rng, step = jax.random.PRNGKey(11), 32
    jnew = j_refresh_maker(field, jrs)(params, jocc, jnp.asarray(b["auds"]),
                                       jnp.asarray(b["eye"]), rng, step)
    k = jax.random.fold_in(jax.random.fold_in(rng, step), 0x6772)
    _, sub = jax.random.split(k)
    jitter = [_t(np.asarray(jax.random.uniform(sub, (GRID ** 3, 3))))]

    tf = TField(audio_in_dim=ds.audio_dim, ind_num=64)
    tf.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tnew = make_density_grid_update(tf, trs)(
        _occ_from(jocc), _t(b["auds"]), _t(b["eye"]), jitter=jitter)
    np.testing.assert_allclose(tnew.density_grid.numpy(),
                               np.asarray(jnew.density_grid), rtol=1e-6)
    np.testing.assert_array_equal(tnew.occ.numpy(), np.asarray(jnew.occ))
    assert 0 < int(tnew.occ.sum()) < tnew.occ.numel()
    assert int(tnew.iter_density) == int(jnew.iter_density) == 1
    # the mean of 32,768 float32 values summed in another order
    np.testing.assert_allclose(float(tnew.mean_density),
                               float(jnew.mean_density), rtol=1e-5)


# ---- the transmittance cut at T_thresh --------------------------------

def _scaled_base(rng, S, spans):
    """A random sigma row [S] whose samples [a, b) sum, times DT, to each
    given optical depth (spans: ((a, b, depth), ...))."""
    base = rng.uniform(30, 60, S).astype(np.float32)
    for a, b, depth in spans:
        base[a:b] *= np.float32(depth / (base[a:b].sum() * DT))
    return base


def _threshold_rows(S, targets, seed, make_base, T_of, scan=(0, 1),
                    tries=40):
    """Sigma rows [len(targets), S] whose transmittance T_of(alphas) (the
    JAX package's product order, on JAX's alphas) equals each target
    exactly. Found by scanning the float32 neighbours of the two samples
    `scan` of seeded rows make_base(rng); rows whose alphas differ
    between the two packages' exp are not used (see the training test's
    docstring)."""

    def nb(x, n):
        out = [x]
        for direction in (np.inf, -np.inf):
            v = x
            for _ in range(n):
                v = np.nextafter(v, np.float32(direction), dtype=np.float32)
                out.append(v)
        return np.array(out, np.float32)

    i0, i1 = scan
    found = {}
    for t in range(tries):
        base = make_base(np.random.default_rng(seed + 1000 * t))
        a0, a1 = np.meshgrid(nb(base[i0], 150), nb(base[i1], 150),
                             indexing="ij")
        sig = np.repeat(base[None], a0.size, 0)
        sig[:, i0], sig[:, i1] = a0.ravel(), a1.ravel()
        ja = np.asarray(1.0 - jnp.exp(-jnp.asarray(sig) * DT))
        ta = (1.0 - torch.exp(-_t(sig) * float(DT))).numpy()
        T = T_of(ja)
        same = (ja == ta).all(axis=1)
        for i, target in enumerate(targets):
            hit = np.flatnonzero((T == target) & same)
            if i not in found and hit.size:
                found[i] = sig[hit[0]]
        if len(found) == len(targets):
            return np.stack([found[i] for i in range(len(targets))])
    raise AssertionError(f"rows reach only targets {sorted(found)}")


DEPTH = float(-np.log(np.float64(T_THRESH)))


def _T_before(k, order):
    """T before sample k from JAX's alphas, in JAX's product order: "seq"
    (jnp.cumprod) or "scan" (jnp.cumprod under differentiation,
    lax.associative_scan)."""
    def T_of(alpha):
        om = jnp.asarray(1.0 - alpha)
        P = (jnp.cumprod(om, axis=-1) if order == "seq" else
             jax.lax.associative_scan(jnp.multiply, om, axis=-1))
        return np.asarray(P)[:, k - 1]
    return T_of


NEIGHBOURS = (np.nextafter(T_THRESH, np.float32(0)), T_THRESH,
              np.nextafter(T_THRESH, np.float32(1)))


def test_training_composite_at_threshold_matches_jax():
    """composite_rays as the training step runs it (differentiated): rays
    whose transmittance before sample 8 is the float32 below, at and above
    T_thresh, one with an opaque sample (alpha = 1, so 1 - alpha = 0 inside
    the cumulative product), and random rays. The processed masks (read
    exactly through ambient inputs of 2^i at sample i) are equal; outputs
    and the gradient of every input agree with jax.grad.

    The alphas of the threshold rows are equal in both packages: exp
    itself is not bit-equal between XLA's and PyTorch's CPU math (about
    1 % of float32 alphas differ by an ulp), and that part of a cut at
    the threshold is outside the port."""
    S = 16
    rows = _threshold_rows(
        S, NEIGHBOURS, 1, lambda r: _scaled_base(r, S, ((0, 8, DEPTH),)),
        _T_before(8, "scan"))
    rng = np.random.default_rng(2)
    opaque = rng.uniform(5, 40, (1, S)).astype(np.float32)
    opaque[0, 3] = 1e4                      # exp(-270) == 0: alpha == 1
    rand = rng.uniform(0, 80, (8, S)).astype(np.float32)
    sig = np.concatenate([rows, opaque, rand])
    N = sig.shape[0]
    mask = np.ones((N, S), bool)
    mask[-2:, 12:] = False
    deltas = np.where(mask, DT, 0).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    rgbs[:3, 8] = 1e3                       # a flipped cut shows loudly
    amb = np.broadcast_to(2.0 ** np.arange(S, dtype=np.float32),
                          (N, S)).copy()
    eye = rng.uniform(0, 1, (N, S)).astype(np.float32)
    unc = rng.uniform(0, 1, (N, S)).astype(np.float32)
    ts = np.cumsum(deltas, axis=1).astype(np.float32)
    w = rng.normal(size=(6,)).astype(np.float32)

    def jloss(s, c, u, e):
        r = j_composite(s, c, jnp.asarray(amb), e, u, jnp.asarray(deltas),
                        jnp.asarray(ts), jnp.asarray(mask),
                        T_thresh=float(T_THRESH))
        return (w[0] * jnp.sum(r.image) + w[1] * jnp.sum(r.depth)
                + w[2] * jnp.sum(r.weights_sum)
                + w[3] * jnp.sum(r.uncertainty_sum)
                + w[4] * jnp.sum(r.amb_eye_sum)), r

    jin = [jnp.asarray(x) for x in (sig, rgbs, unc, eye)]
    (jl, jr), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(*jin)
    tin = [_t(x).requires_grad_(True) for x in (sig, rgbs, unc, eye)]
    tr = t_composite(tin[0], tin[1], _t(amb), tin[3], tin[2], _t(deltas),
                     _t(ts), _t(mask), T_thresh=float(T_THRESH))
    tl = (float(w[0]) * tr.image.sum() + float(w[1]) * tr.depth.sum()
          + float(w[2]) * tr.weights_sum.sum()
          + float(w[3]) * tr.uncertainty_sum.sum()
          + float(w[4]) * tr.amb_eye_sum.sum())
    tl.backward()

    proc = tr.amb_aud_sum.detach().numpy()
    np.testing.assert_array_equal(proc, np.asarray(jr.amb_aud_sum))
    # below: sample 8 cut; at and above: processed
    assert [int(p) >> 8 & 1 for p in proc[:3]] == [0, 1, 1]
    for k in ("image", "depth", "weights_sum", "uncertainty_sum",
              "amb_eye_sum"):
        np.testing.assert_allclose(getattr(tr, k).detach().numpy(),
                                   np.asarray(getattr(jr, k)), atol=1e-6,
                                   err_msg=k)
    for t, j, name in zip(tin, jg, ("sigma", "rgb", "unc", "eye")):
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-9, err_msg=name)


def test_serving_staged_composite_at_threshold_matches_jax():
    """_staged_eval_composite (split 8 of 16, forward only, so the JAX
    package multiplies left to right): rays whose transmittance is the
    float32 below, at and above T_thresh at the split (the stage-2
    survivor test), inside stage 1 (at sample 5) and inside stage 2 (at
    sample 12, T = T_split x the stage-2 product). The stage-2 survivor
    count is equal, and images agree within 1e-6 where a flipped cut
    would move them by about 1e-2 (colour 1e3 at the cut sample).
    Alphas of the rows are equal in both packages, as in the training
    test."""
    S, split = 16, 8
    at_split = _threshold_rows(
        S, NEIGHBOURS, 3, lambda r: _scaled_base(r, S, ((0, split, DEPTH),)),
        _T_before(split, "seq"))
    in_s1 = _threshold_rows(
        S, NEIGHBOURS, 4, lambda r: _scaled_base(r, S, ((0, 5, DEPTH),)),
        _T_before(5, "seq"))

    def T_in_stage2(alpha):
        # the staged composite: T at sample 12 = T_split x the left-to-right
        # product of stage 2's first four factors
        om = 1.0 - alpha
        T_split = np.asarray(jnp.cumprod(jnp.asarray(om[:, :split]),
                                         axis=-1))[:, -1]
        P2 = np.asarray(jnp.cumprod(jnp.asarray(om[:, split:]), axis=-1))
        return T_split * P2[:, 3]

    in_s2 = _threshold_rows(
        S, NEIGHBOURS, 5,
        lambda r: _scaled_base(r, S, ((0, split, 4.0),
                                      (split, 12, DEPTH - 4.0))),
        T_in_stage2, scan=(split, split + 1))
    sig = np.concatenate([at_split, in_s1, in_s2])
    B = sig.shape[0]
    rgb = np.full((B, S, 3), 0.5, np.float32)
    rgb[3:6, 5] = 1e3
    rgb[6:9, 12] = 1e3
    # the field reads each sample's id from its x coordinate
    ids = np.arange(B * S, dtype=np.float32).reshape(B, S)
    xyzs = np.stack([ids, np.zeros_like(ids), np.zeros_like(ids)], -1)
    mask = np.ones((B, S), bool)
    deltas = np.full((B, S), DT, np.float32)
    ts = np.cumsum(deltas, 1).astype(np.float32)
    rd = np.tile(np.float32([0, 0, 1]), (B, 1))
    sig_f, rgb_f = sig.reshape(-1), rgb.reshape(-1, 3)

    class Out:
        def __init__(self, s, c):
            self.sigma, self.color = s, c

    def j_apply(params, pts, dirs, *a, **k):
        i = pts[:, 0].astype(jnp.int32)
        return Out(jnp.asarray(sig_f)[i], jnp.asarray(rgb_f)[i])

    def t_apply(pts, dirs):
        i = pts[:, 0].to(torch.int64)
        return _t(sig_f)[i], _t(rgb_f)[i]

    jrs = JRS(T_thresh=float(T_THRESH))
    trs = TRS(T_thresh=float(T_THRESH))
    jres = jm.MarchResult(xyzs=jnp.asarray(xyzs), deltas=jnp.asarray(deltas),
                          ts=jnp.asarray(ts), mask=jnp.asarray(mask))
    tres = tm.MarchResult(xyzs=_t(xyzs), deltas=_t(deltas), ts=_t(ts),
                          mask=_t(mask))
    j_img, j_ws, j_n2, _ = j_staged(j_apply, None, jrs, jres, jnp.asarray(rd),
                                    None, None, None, B, S, split, 16)
    t_img, t_ws, t_n2, _ = t_staged(t_apply, trs, tres, _t(rd), B, S, split,
                                    16)
    # survivors at the split: at and above of the split rows, and the
    # three stage-2 rows (their transmittance at the split is about e^-4)
    assert int(t_n2) == int(j_n2) == 5
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-6)
    np.testing.assert_allclose(t_ws.numpy(), np.asarray(j_ws), atol=1e-6)
    # the cut inside each stage: below cuts the bright sample, at and
    # above keep it
    lit = t_img.numpy()[3:9, 0]
    assert min(lit[1], lit[2]) - lit[0] > 1e-2
    assert min(lit[4], lit[5]) - lit[3] > 1e-2
