"""Parity of the port's block march (lzzx_nerf_tpu_torch/ops/march2.py,
march_select.py) with the JAX package's nb5wp march, whose select is the
Pallas kernel (run here in interpret mode), on the nb5wp cases of
tests/test_march2.py: real-camera blocks at three distances, fragmented
random occupancy, the multi-word grid-64 scene, and an odd candidate count
with fewer blocks than the Pallas tile.

The port's plain select (march_select_reference, what the CUDA kernel is
held to on the card) must give EQUAL sample indices and masks; positions
agree to 1e-6 (the same float32 ops in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu.ops.march_select_pallas import march_select_pallas
from lzzx_nerf_tpu.ops.ray import near_far_from_aabb as j_nearfar
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from lzzx_nerf_tpu_torch.ops.march_select import (march_select,
                                                  march_select_cuda,
                                                  march_select_reference)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(grid):
    r = jnp.linspace(-1, 1, grid)
    X, Y, Z = jnp.meshgrid(r, r, r, indexing="ij")
    return (jnp.sqrt(X ** 2 + (2 * Y) ** 2 + Z ** 2) < 0.45)[None]


def _random_blobs(grid, seed=3):
    rng = np.random.default_rng(seed)
    occ = np.zeros((grid, grid, grid), bool)
    for _ in range(12):
        c = rng.integers(4, grid - 4, 3)
        r = rng.integers(2, 5)
        x, y, z = np.ogrid[:grid, :grid, :grid]
        occ |= ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) < r ** 2
    return jnp.asarray(occ)[None]


def _two_sphere_grid64():
    r = jnp.linspace(-1, 1, 64)
    X, Y, Z = jnp.meshgrid(r, r, r, indexing="ij")
    return ((jnp.sqrt(X ** 2 + (2 * Y) ** 2 + Z ** 2) < 0.4)
            | (jnp.sqrt((X - 0.3) ** 2 + (2 * Y) ** 2 + (Z - 0.45) ** 2)
               < 0.22))[None]


def _block_march_inputs(occ, H, W, z, fov_scale, bound, dt):
    """render_rays_compact_blocks' march prep (as tests/test_march2.py
    builds it), in JAX: pinhole rays, block-centre windows, per-ray
    near-anchored re-snap. Returns numpy arrays."""
    aabb = jnp.asarray([-1, -0.5, -1, 1, 0.5, 1], jnp.float32)
    pose = jnp.asarray(np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, z], [0, 0, 0, 1]],
        np.float32))[None]
    intr = (W / fov_scale, W / fov_scale, W / 2, H / 2)
    rays = j_get_rays(pose, intr, H, W, N=-1)
    origin, rd_full = rays["rays_o"][0][0], rays["rays_d"][0]
    NB = H * W // 4
    d_blocks = rd_full.reshape(H // 2, 2, W // 2, 2, 3).transpose(
        0, 2, 1, 3, 4).reshape(NB, 4, 3)
    d_center = d_blocks.mean(axis=1)
    d_center = d_center / jnp.linalg.norm(d_center, axis=-1, keepdims=True)
    o_center = jnp.broadcast_to(origin, d_center.shape)
    nears_b, fars_b = j_nearfar(o_center, d_center, aabb, 0.05)
    z_lo, z_hi = jm2.column_intervals(occ, bound)
    win = jm2.ray_windows(o_center, d_center, nears_b, fars_b, z_lo, z_hi,
                          bound, dt, pad_steps=3.0)
    cs = jm2.compact_rays(win.active, NB)
    rows = jnp.take(jnp.concatenate(
        [d_blocks.reshape(NB, 12), win.t_start[:, None],
         win.t_end[:, None], d_center], axis=-1), cs.ray_idx, axis=0)
    rd = rows[:, :12].reshape(-1, 3)
    t0_blk = rows[:, 12]
    t0b, t1b = jnp.repeat(t0_blk, 4), jnp.repeat(rows[:, 13], 4)
    dc = rows[:, 14:17]
    ro = jnp.broadcast_to(origin, rd.shape)
    slot_valid = jnp.repeat(cs.slot_valid, 4)
    nears_r, fars_r = j_nearfar(ro, rd, aabb, 0.05)
    t_start = jnp.maximum(nears_r, t0b)
    k0 = jnp.ceil(jnp.maximum(t_start - nears_r, 0.0) / dt - 1e-4)
    t_start = nears_r + k0 * dt
    t_end = jnp.minimum(fars_r, t1b)
    return tuple(np.asarray(a) for a in (ro, rd, t_start, t_end, slot_valid,
                                         t0_blk, dc))


def _anchors(ro, t0_blk, dc, H, bound, dt, G):
    """The group anchors exactly as the JAX nb5w/nb5wp march derives them."""
    Bb = t0_blk.shape[0]
    W32 = H // 32
    o_blk = jnp.asarray(ro).reshape(Bb, 4, 3).mean(axis=1)
    gk = jnp.arange(G, dtype=jnp.float32) * 2 + 1.0
    t_g = jnp.asarray(t0_blk)[:, None] + gk[None] * dt
    pg = jnp.clip(o_blk[:, None, :] + t_g[..., None]
                  * jnp.asarray(dc)[:, None, :], -bound, bound)
    g = [jnp.clip((pg[..., a] / bound + 1.0) * 0.5 * H, 0, H - 1).astype(
        jnp.int32) for a in range(3)]
    w0 = jnp.clip(jnp.maximum(g[2] - 3, 0) >> 5, 0, W32 - 1)
    return g[0], g[1], w0


CASES = {
    # tests/test_march2.py:575 (three camera distances / fields of view)
    "camera_z2.5": (lambda: _sphere(32), 32, 32, -2.5, 0.6, 32, 40, 16),
    "camera_z1.8": (lambda: _sphere(32), 32, 32, -1.8, 0.9, 32, 40, 16),
    "camera_z3.5": (lambda: _sphere(32), 32, 32, -3.5, 0.4, 32, 40, 16),
    # tests/test_march2.py:608 (fragmented random occupancy)
    "random_blobs": (lambda: _random_blobs(32), 32, 32, -2.5, 0.6, 32, 48,
                     16),
    # tests/test_march2.py:1306 (grid 64: two z-words per column)
    "grid64_multiword": (_two_sphere_grid64, 128, 128, -2.5, 0.35, 64, 48,
                         16),
    # tests/test_march2.py:1588 (odd K2, blocks below the Pallas tile)
    "odd_k2_padding": (lambda: _sphere(32), 32, 32, -2.5, 0.6, 32, 45, 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_select_matches_pallas(case):
    make_occ, H, W, z, fs, grid, K2, S = CASES[case]
    bound, dt = 1.0, 2 * 3 ** 0.5 / grid
    occ = make_occ()
    ro, rd, t0, t1, sv, t0_blk, dc = _block_march_inputs(
        occ, H, W, z, fs, bound, dt)
    table = jm2.column_bitmasks_neighborhood5_words(occ)
    G = (K2 + 1) // 2
    gx, gy, w0 = _anchors(ro, t0_blk, dc, grid, bound, dt, G)
    W32 = grid // 32

    # the select alone: Pallas kernel (interpret) vs the port's plain
    # version on the same anchors — equal indices
    rows = jnp.take(table, ((gx * grid + gy) * W32 + w0).reshape(-1),
                    axis=0)
    j_sel = np.asarray(march_select_pallas(
        rows, gx, gy, w0, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t0),
        jnp.asarray(t1), jnp.asarray(sv), bound, dt, grid, K2, S))
    t_table = tm2.column_bitmasks_neighborhood5_words(_t(occ))
    t_sel = march_select_reference(
        t_table, _t(gx), _t(gy), _t(w0), _t(ro), _t(rd), _t(t0), _t(t1),
        _t(sv), bound, dt, grid, K2, S)
    np.testing.assert_array_equal(t_sel.numpy(), j_sel)
    assert (j_sel >= 0).sum() > 100            # the scene actually marched

    # the whole block march, nb5wp (wrapper) and nb5w (plain) variants,
    # against the JAX nb5w march (bit-exact to its nb5wp by the JAX
    # package's own tests; the Pallas select already ran above)
    jm = jm2.march_rays_window_bitmask_nb_block(
        *map(jnp.asarray, (ro, rd, t0, t1, sv, t0_blk, dc)), table, bound,
        dt, K2, S, variant="nb5w")
    for variant in ("nb5wp", "nb5w"):
        tm = tm2.march_rays_window_bitmask_nb_block(
            *map(_t, (ro, rd, t0, t1, sv, t0_blk, dc)), t_table, bound, dt,
            K2, S, variant=variant)
        np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
        for name in ("xyzs", "ts", "deltas"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       np.asarray(getattr(jm, name)),
                                       rtol=0, atol=1e-6, err_msg=name)


def test_march_select_device_contract():
    """CPU tensors take the plain version through the wrapper; the CUDA
    entry point refuses CPU tensors rather than falling back."""
    occ = _sphere(32)
    table = tm2.column_bitmasks_neighborhood5_words(_t(occ))
    z = torch.zeros((1, 2), dtype=torch.int32)
    ro = torch.zeros((4, 3))
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    ts = torch.full((4,), 1.5)
    te = torch.full((4,), 3.5)
    sv = torch.ones(4, dtype=torch.bool)
    out = march_select(table, z, z, z, ro, rd, ts, te, sv, 1.0, 0.1, 32, 4,
                       2)
    assert out.shape == (4, 2) and out.dtype == torch.int32
    with pytest.raises(ValueError):
        march_select_cuda(table, z, z, z, ro, rd, ts, te, sv, 1.0, 0.1, 32,
                          4, 2)
