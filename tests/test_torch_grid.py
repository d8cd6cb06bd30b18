"""The port's grid encoder (lzzx_nerf_tpu_torch/ops/grid.py) against the
JAX package's (lzzx_nerf_tpu/ops/grid.py) and tests/golden.py's
golden_grid_encode, on the CPU.

Specs: the hash head's triplane_spec(1) (2-D, 12 levels x 1 channel,
levels 0-3 dense and 4-11 hashed), the tiled torso's torso_tiled_spec()
(2-D, 16 levels x 2 channels) and a 3-D hash spec. Inputs from a numpy
seed, with points outside [-1, 1] and points within a few float32 ulps of
every level's cell boundaries.

Tolerances:
- make_grid_spec: every field equal;
- forward: bit-equal to JAX (the same float32 operations in the same
  order: 0 of the boundary points picks another corner than JAX);
  against the golden (float64 interpolation) 2e-4 absolute, as
  tests/test_ops.py holds JAX's; out-of-bound points exactly zero;
- backward: the table gradient (a scatter-add whose sums run in another
  order than XLA's) within 1e-6 of the largest entry, relative; the input
  gradient within 1e-6 relative of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import golden_grid_encode, golden_grid_offsets
from lzzx_nerf_tpu.models.nerf import torso_tiled_spec as j_torso_spec
from lzzx_nerf_tpu.models.nerf import triplane_spec as j_triplane_spec
from lzzx_nerf_tpu.ops import grid as jg
from lzzx_nerf_tpu_torch.models.nerf import torso_tiled_spec, triplane_spec
from lzzx_nerf_tpu_torch.ops import grid as tg
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

SPECS = {
    "triplane": dict(input_dim=2, num_levels=12, level_dim=1,
                     base_resolution=64, log2_hashmap_size=14,
                     desired_resolution=512, gridtype="hash"),
    "torso_tiled": dict(input_dim=2, num_levels=16, level_dim=2,
                        base_resolution=16, log2_hashmap_size=16,
                        desired_resolution=2048, gridtype="tiled"),
    "hash3d": dict(input_dim=3, num_levels=8, level_dim=2,
                   base_resolution=16, log2_hashmap_size=12,
                   desired_resolution=256, gridtype="hash"),
}
GRAD_RTOL = 1e-6


def _inputs(spec, n, seed):
    """n points in [-1.05, 1.05]^D (some out of bounds, one row exactly
    at +1 and one at -1), then points a few ulps either side of a
    cell boundary at every level, and the table."""
    rng = np.random.default_rng(seed)
    D = spec.input_dim
    x = rng.uniform(-1.05, 1.05, (n, D)).astype(np.float32)
    x[0], x[1] = 1.0, -1.0
    edges = []
    for scale in spec.scales:
        # u * scale + 0.5 = k: a boundary of level `scale`
        k = rng.integers(1, int(scale), size=(16, D))
        u = ((k - 0.5) / scale).astype(np.float32)
        for ulps in (-2, -1, 0, 1, 2):
            xb = (u * 2.0 - 1.0).astype(np.float32)
            xb = xb + ulps * np.spacing(np.abs(xb)).astype(np.float32)
            edges.append(xb)
    x = np.concatenate([x] + edges).astype(np.float32)
    table = rng.standard_normal((spec.total_params,
                                 spec.level_dim)).astype(np.float32)
    return x, table


def test_real_specs_equal_jax():
    for t, j in ((triplane_spec(1.0), j_triplane_spec(1.0)),
                 (triplane_spec(2.0), j_triplane_spec(2.0)),
                 (torso_tiled_spec(), j_torso_spec())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    t = triplane_spec(1.0)
    assert t.total_params == 163_584 and t.output_dim == 12
    assert t.use_hash == (False,) * 4 + (True,) * 8
    assert torso_tiled_spec().total_params == 555_520


@pytest.mark.parametrize("name", list(SPECS))
def test_make_grid_spec_equal_field_by_field(name):
    js, ts = jg.make_grid_spec(**SPECS[name]), tg.make_grid_spec(**SPECS[name])
    for f in js.__dataclass_fields__:
        assert getattr(ts, f) == getattr(js, f), f
    assert list(ts.offsets) == golden_grid_offsets(
        ts.input_dim, ts.num_levels, ts.per_level_scale,
        ts.base_resolution, ts.log2_hashmap_size, ts.align_corners)


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_equals_jax_and_golden(name):
    spec = tg.make_grid_spec(**SPECS[name])
    x, table = _inputs(spec, 256, seed=len(name))
    got = tg.grid_encode(torch.from_numpy(x), torch.from_numpy(table),
                         spec).numpy()
    want = np.asarray(jg.grid_encode(jnp.asarray(x), jnp.asarray(table),
                                     jg.make_grid_spec(**SPECS[name])))
    differ = np.any(got != want, axis=-1)
    assert int(differ.sum()) == 0, np.nonzero(differ)[0][:10]
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert oob.sum() > 10 and np.all(got[oob] == 0.0)
    gold = golden_grid_encode(
        (x.astype(np.float64) + 1.0) / 2.0, table.astype(np.float64),
        list(spec.offsets), spec.per_level_scale, spec.base_resolution,
        spec.gridtype, spec.align_corners)
    np.testing.assert_allclose(got, gold, atol=2e-4)


@pytest.mark.parametrize("name", list(SPECS))
def test_backward_equals_jax(name):
    """The table gradient (the gather's transpose) and the input gradient
    of a seeded weighted sum of the features."""
    spec = tg.make_grid_spec(**SPECS[name])
    js = jg.make_grid_spec(**SPECS[name])
    x, table = _inputs(spec, 512, seed=7 + len(name))
    w = np.random.default_rng(3).standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32)

    def jloss(t, v):
        return jnp.sum(jg.grid_encode(v, t, js) * w)

    g_tab, g_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                 jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    torch.sum(tg.grid_encode(xx, tt, spec) * torch.from_numpy(w)).backward()
    for got, want in ((tt.grad, g_tab), (xx.grad, g_x)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=GRAD_RTOL * scale)
    # the points outside the box take no input gradient
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert np.all(xx.grad.numpy()[oob] == 0.0)


def test_init_is_uniform_small():
    spec = triplane_spec(1.0)
    t = tg.init_grid_embeddings(spec, torch.Generator().manual_seed(0))
    assert t.shape == (163_584, 1)
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 5e-5
