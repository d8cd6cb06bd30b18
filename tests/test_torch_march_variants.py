"""Parity of the port's march alternates (lzzx_nerf_tpu_torch/ops/march2.py)
with the JAX package's, on the same seeded scenes (tests/test_torch_march.py's
real-camera blocks at grid 32 and the two-word grid-64 scene):

- every bit table the port builds bit-equal to JAX's (the uint32 patterns
  the port keeps in int32);
- each group-2 block variant (wslice, nb_first, zband, zband4, quad, quadw,
  quadwx, nb5wz, nb5wz4), which the port marches through nb5w's select,
  against JAX's own variant over its own table; the block-lattice group 3
  and the dilated single-column march: masks and selected lattice indices
  EQUAL, positions within 1e-5 (tests/test_march2.py's tolerance for these
  marches);
- resolve_march_plan's (K2, group, variant), step-downs included, equal;
- the block-lattice march's word-pair envelope counter stays at zero over
  the scenes.

JAX runs through its plain XLA path (no Pallas kernel on these variants)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.ops import march2 as jm2
from lzzx_nerf_tpu_torch.ops import march2 as tm2
from test_torch_march import (_block_march_inputs, _random_blobs, _sphere, _t,
                              _two_sphere_grid64)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

POS_TOL = 1e-5
# (occupancy, frame H, W, camera z, fov scale, grid, K2, S)
SCENES = {
    "grid32": (lambda: _sphere(32), 32, 32, -2.5, 0.6, 32, 40, 16),
    "blobs32": (lambda: _random_blobs(32), 32, 32, -2.5, 0.6, 32, 48, 12),
    "grid64": (_two_sphere_grid64, 64, 64, -2.5, 0.35, 64, 48, 16),
}
TABLES = {
    "bit": ("column_bitmasks", "col_bitmask"),
    "nb": ("column_bitmasks_neighborhood", "col_nbmask"),
    "nb5w": ("column_bitmasks_neighborhood5_words", "col_nb5wmask"),
    "dil": ("dilated_occupancy_words", "col_dilwords"),
}
# the table each JAX variant reads (JAX's needed_variant_tables names it)
JAX_VARIANT_TABLES = {
    "nb5": jm2.column_bitmasks_neighborhood5,
    "nb5w": jm2.column_bitmasks_neighborhood5_words,
    "quad": jm2.column_bitmasks_quadrant,
    "quadw": jm2.column_bitmasks_quadrant_words,
    "quadwx": jm2.column_bitmasks_quadrant_words_xfold,
}
VARIANTS = ("wslice", "nb_first", "zband", "zband4", "quad", "quadw",
            "quadwx", "nb5wz", "nb5wz4")
_inputs = {}


def _scene(name):
    if name not in _inputs:
        make_occ, H, W, z, fs, grid, K2, S = SCENES[name]
        occ = make_occ()
        dt = 2 * 3 ** 0.5 / grid
        _inputs[name] = (occ, _block_march_inputs(occ, H, W, z, fs, 1.0, dt),
                         dt, K2, S)
    return _inputs[name]


def _u32(t):
    return t.numpy().view(np.uint32)


def _same_march(tm, jm, name=""):
    """Masks equal, the selected lattice positions (ts) and points within
    POS_TOL, deltas equal."""
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask), name)
    np.testing.assert_array_equal(tm.deltas.numpy(), np.asarray(jm.deltas),
                                  name)
    for k in ("ts", "xyzs"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=POS_TOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("grid", (32, 64))
@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_bit_equal_to_jax(table, grid):
    occ = _sphere(grid) if grid == 32 else _two_sphere_grid64()
    fn = TABLES[table][0]
    want = np.asarray(getattr(jm2, fn)(occ))
    got = getattr(tm2, fn)(_t(occ))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)
    # build_inference_tables fills the field the plan reads
    tabs = tm2.build_inference_tables(_t(occ), 1.0, variants=(table,))
    np.testing.assert_array_equal(_u32(getattr(tabs, TABLES[table][1])),
                                  want)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_variant_matches_jax(variant, scene):
    """JAX's variant, over its own table through its own select, against
    the port's march of the same variant name (nb5w's select over the
    nb5w table the port builds for every variant)."""
    occ, (ro, rd, t0, t1, sv, t0_blk, dc), dt, K2, S = _scene(scene)
    jkey = jm2.needed_variant_tables(2, variant)[0]
    jm = jm2.march_rays_window_bitmask_nb_block(
        *map(jnp.asarray, (ro, rd, t0, t1, sv, t0_blk, dc)),
        JAX_VARIANT_TABLES[jkey](occ), 1.0, dt, K2, S, variant=variant)
    tab = tm2.build_inference_tables(
        _t(occ), 1.0, variants=tm2.needed_variant_tables(2, variant))
    tm = tm2.march_rays_window_bitmask_nb_block(
        *map(_t, (ro, rd, t0, t1, sv, t0_blk, dc)), tab.col_nb5wmask, 1.0,
        dt, K2, S, variant=variant)
    assert int(np.asarray(jm.mask).sum()) > 100        # the scene marched
    _same_march(tm, jm, variant)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_group3_block_lattice_matches_jax(scene):
    occ, (ro, rd, t0, t1, sv, t0_blk, dc), dt, K2, S = _scene(scene)
    # nears: each ray's AABB entry, pushed past the block anchor for some
    # rays so the masking of early candidates is exercised
    rng = np.random.default_rng(5)
    nears = (np.repeat(t0_blk, 4) + rng.integers(0, 4, len(ro)) * dt
             + rng.uniform(0.1, 0.9, len(ro)) * dt).astype(np.float32)
    nb = jm2.column_bitmasks_neighborhood(occ)
    jm = jm2.march_rays_window_bitmask_nb_block3(
        *map(jnp.asarray, (ro, rd, nears, t1, sv, t0_blk, dc)), nb, 1.0, dt,
        K2, S)
    tm = tm2.march_rays_window_bitmask_nb_block3(
        *map(_t, (ro, rd, nears, t1, sv, t0_blk, dc)),
        tm2.column_bitmasks_neighborhood(_t(occ)), 1.0, dt, K2, S)
    assert int(np.asarray(jm.mask).sum()) > 100
    _same_march(tm, jm, "group 3")


@pytest.mark.parametrize("group", (2, 3))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dilated_march_matches_jax(scene, group):
    occ, (ro, rd, t0, t1, sv, _, _), dt, K2, S = _scene(scene)
    jm = jm2.march_rays_window_bitmask(
        *map(jnp.asarray, (ro, rd, t0, t1, sv)), jm2.column_bitmasks(occ),
        1.0, dt, K2, S, group=group)
    tm = tm2.march_rays_window_bitmask(
        *map(_t, (ro, rd, t0, t1, sv)), tm2.column_bitmasks(_t(occ)), 1.0,
        dt, K2, S, group=group)
    assert int(np.asarray(jm.mask).sum()) > 100
    _same_march(tm, jm, f"dilated group {group}")


class _S:
    bound = 1.0
    grid_size = 128
    dt = 2 * 3 ** 0.5 / 128
    max_steps = 16
    min_near = 0.05
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)


def _plan_scene(z_cam, focal_mult):
    z_lo = np.full((128, 128), 1e30, np.float32)
    z_hi = np.full((128, 128), -1e30, np.float32)
    z_lo[60:68, 60:68] = -0.2
    z_hi[60:68, 60:68] = 0.2
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = z_cam
    intr = (128 * focal_mult, 128 * focal_mult, 64, 64)
    return z_lo, z_hi, pose[None], intr


# (camera z, focal / width): a portrait camera where every envelope holds,
# an oblique one where the quadrant and block-lattice envelopes fail but
# the block march's ±2 holds, and a wide one where that fails too
GEOMETRIES = {"portrait": (-3.0, 4.0), "oblique": (-2.0, 2.0),
              "wide": (-3.0, 1.2)}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("group,variant", [
    (2, "nb5w"), (2, "quad"), (2, "quadw"), (2, "quadwx"), (2, "zband4"),
    (3, "nb5w"), (3, "quad"), (1, "nb5w"), (-2, "nb5w")])
def test_resolve_march_plan_matches_jax(group, variant, geometry):
    z_lo, z_hi, poses, intr = _plan_scene(*GEOMETRIES[geometry])
    kw = dict(k2_override=0, march_group=group, march_variant=variant,
              log=lambda m: None)
    want = jm2.resolve_march_plan(_S, jnp.asarray(z_lo), jnp.asarray(z_hi),
                                  poses, intr, 128, 128, **kw)
    got = tm2.resolve_march_plan(_S, torch.from_numpy(z_lo),
                                 torch.from_numpy(z_hi), poses, intr, 128,
                                 128, **kw)
    assert got == tuple(want)


def test_plan_geometries_step_down():
    """The fixture's geometries exercise each step-down (so the parity
    above covers them): portrait keeps group 3 and quad, oblique
    steps 3 -> 2 and quad -> nb5w, wide steps 2 -> 1."""
    def plan(geometry, group, variant):
        z_lo, z_hi, poses, intr = _plan_scene(*GEOMETRIES[geometry])
        return tm2.resolve_march_plan(
            _S, torch.from_numpy(z_lo), torch.from_numpy(z_hi), poses, intr,
            128, 128, march_group=group, march_variant=variant,
            log=lambda m: None)[1:]
    assert plan("portrait", 3, "quad") == (3, "quad")
    assert plan("portrait", 2, "quadw") == (2, "quadw")
    assert plan("oblique", 3, "nb5w") == (2, "nb5w")
    assert plan("oblique", 2, "quad") == (2, "nb5w")
    assert plan("wide", 2, "nb5w") == (1, "nb5w")


@pytest.mark.parametrize("fn", ("nb_block_drift_cells",
                                "nb_blockq_drift_cells",
                                "nb_block3_drift_cells"))
def test_drift_envelopes_equal_jax(fn):
    for dt, focal, t_max, dz in ((0.027, 853.0, 3.4, 0.85),
                                 (0.054, 116.0, 2.8, 0.6),
                                 (0.1, 32.0, 4.0, 0.99)):
        want = getattr(jm2, fn)(dt, 1.0, 128, focal, t_max, dz)
        assert getattr(tm2, fn)(dt, 1.0, 128, focal, t_max, dz) == want


@pytest.mark.parametrize("group,variant,prepass", [
    (2, "nb5w", True), (2, "nb5wp", False), (2, "nb5wz4", True),
    (2, "wslice", False), (2, "zband", True), (2, "quad", False),
    (2, "quadw", True), (2, "quadwx", False), (3, "nb5w", False),
    (1, "nb5w", False), (-2, "nb5w", False)])
def test_needed_tables_follow_jax(group, variant, prepass):
    """The port builds, per plan, the group-2 tables JAX's
    needed_variant_tables names, with the nb5w table in place of the
    variant's own (every variant marches through nb5w's select); groups 1
    and 3 read the 3x3 table and a negative group the dilated one (JAX
    builds those two with every plan)."""
    got = tm2.needed_variant_tables(group, variant, prepass=prepass)
    want = jm2.needed_variant_tables(group, variant, prepass=prepass)
    if group == 2:
        assert got == ("nb5w",) + tuple(want[1:])
    else:
        assert want == () and got == (("bit",) if group < 0 else ("nb",))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_word_envelope_holds(scene, monkeypatch):
    """The block-lattice march's word-pair select never reads outside
    {w0, w0 + 1} on the scene (the JAX package's DEBUG_WORD_ENVELOPE
    check, held on the port)."""
    monkeypatch.setattr(tm2, "DEBUG_WORD_ENVELOPE", True)
    tm2.reset_word_envelope_violations()
    occ, (ro, rd, t0, t1, sv, t0_blk, dc), dt, K2, S = _scene(scene)
    args = list(map(_t, (ro, rd, t0, t1, sv, t0_blk, dc)))
    args[2] = args[2] * 0
    m = tm2.march_rays_window_bitmask_nb_block3(
        *args, tm2.column_bitmasks_neighborhood(_t(occ)), 1.0, dt, K2, S)
    assert int(m.mask.sum()) > 100
    assert tm2.word_envelope_violations() == 0


def test_block_march_refuses_a_foreign_table():
    occ, (ro, rd, t0, t1, sv, t0_blk, dc), dt, K2, S = _scene("grid32")
    with pytest.raises(ValueError, match="nb5w"):
        tm2.march_rays_window_bitmask_nb_block(
            *map(_t, (ro, rd, t0, t1, sv, t0_blk, dc)),
            tm2.column_bitmasks_neighborhood(_t(occ)), 1.0, dt, K2, S,
            variant="quadw")
    with pytest.raises(ValueError, match="unknown"):
        tm2.needed_variant_tables(2, "nb7")
