"""Patch-sampled training in the port (--patch_size > 1) against the JAX
package on the CPU: the patch sampler's layout, range and count; a patch
step (patch_size 32, 1,024 rays: one 32² patch, 0.1 x its LPIPS on the
fixture weights) on JAX's draws at tests/test_train.py's sizes (48², grid
32, S 8), the full path at steps 0 and 32 (the compacted path with
patches: tests/test_torch_parallel.py); the term's weight; and the CLI's
LPIPS gate.

Tolerances (tests/test_torch_train_step.py's): loss and mse rtol 2e-5;
every gradient to the step rule; the updated parameters but the tables
rtol 5e-4 / atol 5e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train import lpips as jlp
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from lzzx_nerf_tpu_torch.train import lpips as tlp
from lzzx_nerf_tpu_torch.utils.rays import patch_inds
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (ITERS, LOSS_RTOL, N_RAYS, PARAM_ATOL,
                                   PARAM_RTOL, RES, S, _assert_grad_close,
                                   _capture, _port, _tbatch,
                                   world)  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "lpips_fixture.npz")
P = 32


def _layout(inds, H, W, p):
    """(origins [n, 2], ok): the patch origins of flat pixel indices, and
    whether ray k·p² + a·p + b is pixel (x_k + a, y_k + b)."""
    inds = np.asarray(inds).reshape(-1, p, p)
    rows, cols = inds // W, inds % W
    x0, y0 = rows[:, 0, 0], cols[:, 0, 0]
    a = np.arange(p)
    ok = (np.array_equal(rows, x0[:, None, None] + a[None, :, None]
                         + 0 * a[None, None, :])
          and np.array_equal(cols, y0[:, None, None] + a[None, None, :]
                             + 0 * a[None, :, None]))
    return np.stack([x0, y0], -1), ok


@pytest.mark.parametrize("H,W,N,p", [(48, 48, 1024, 32), (64, 40, 4096, 8),
                                     (40, 64, 5000, 4)])
def test_patch_sampler_layout_range_and_count(H, W, N, p):
    """The port's sampler and JAX's get_rays(patch_size=p): N // p² patches
    (p² rays each), row-major offsets, row origins in [0, H - p) and
    column origins in [0, W - p) (the reference's exclusive bound)."""
    j = j_get_rays(jnp.eye(4)[None], (50.0, 50.0, W / 2, H / 2), H, W,
                   N=N, patch_size=p, rng=jax.random.PRNGKey(1))
    t = patch_inds(H, W, N, p, torch.Generator().manual_seed(1))
    n_patch = min(N, H * W) // (p * p)
    for inds in (np.asarray(j["inds"][0]), t.numpy()):
        assert inds.shape == (n_patch * p * p,)
        origins, ok = _layout(inds, H, W, p)
        assert ok
        assert (origins[:, 0] >= 0).all() and (origins[:, 0] < H - p).all()
        assert (origins[:, 1] >= 0).all() and (origins[:, 1] < W - p).all()
    # the bound is exclusive: 6 x 7 pixels in 4² patches leave row origins
    # {0, 1} and column origins {0, 1, 2}, and many draws reach them all
    j = j_get_rays(jnp.eye(4)[None], (5.0, 5.0, 3.5, 3.0), 6, 7, N=42,
                   patch_size=4, rng=jax.random.PRNGKey(2))
    many = [np.asarray(j["inds"][0])] + [
        patch_inds(6, 7, 42, 4, torch.Generator().manual_seed(s)).numpy()
        for s in range(40)]
    j_org = _layout(many[0], 6, 7, 4)[0]
    t_org = np.concatenate([_layout(m, 6, 7, 4)[0] for m in many[1:]])
    assert set(t_org[:, 0]) == {0, 1} and set(t_org[:, 1]) == {0, 1, 2}
    assert set(j_org[:, 0]) <= {0, 1} and set(j_org[:, 1]) <= {0, 1, 2}


def test_lpips_over_a_batch_of_patches_matches_jax():
    """LPIPS of three 32² patches at once on the fixture weights: each
    patch's distance within 1e-5 relative of JAX's, and of the port's own
    distance of that patch alone."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, P, P, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (3, P, P, 3)).astype(np.float32)
    want = np.asarray(jlp.lpips(jlp.load_weights(FIXTURE), x, y))
    tp = tlp.load_weights(FIXTURE)
    got = tlp.lpips(tp, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for i in range(3):
        one = tlp.lpips(tp, torch.from_numpy(x[i:i + 1]),
                        torch.from_numpy(y[i:i + 1])).numpy()
        np.testing.assert_allclose(one[0], got[i], rtol=1e-5)


@pytest.fixture(scope="module")
def patch_world(world):
    w = world
    tx = _capture(build_optimizer(lr=1e-2, lr_net=1e-3, iters=ITERS))
    kw = dict(w["common"], patch_size=P, lpips_params=jlp.load_weights(
        FIXTURE))
    return dict(tx=tx, step=jax.jit(j_make_step(w["field"], w["jrs"], tx,
                                                **kw)))


def _patch_draws(w, rng, step, rows):
    """make_train_step's draws for a patch step: the get_rays patch
    sample from the rays key, then noise, eye jitter, regulariser."""
    k = jax.random.fold_in(rng, step)
    r_rays, r_noise, r_reg, r_eye = jax.random.split(k, 4)
    rays = j_get_rays(jnp.asarray(w["batch"]["pose"])[None],
                      w["ds"].intrinsics, RES, RES, N=N_RAYS, patch_size=P,
                      rng=r_rays)
    d = {"inds": np.asarray(rays["inds"][0]),
         "noise": np.asarray(jax.random.uniform(r_noise, (N_RAYS,))),
         "eye_jitter": np.asarray(jax.random.uniform(r_eye, (1,))),
         "reg_delta": np.asarray(jax.random.uniform(r_reg, (rows, 3)))}
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k == "inds" else torch.float32) for k, v in d.items()}


@pytest.mark.parametrize("step", [0, 32])
def test_patch_step_matches_jax(world, patch_world, step):
    """Loss, mse, every gradient and the updated parameters after one
    patch step against JAX's make_train_step(patch_size=32,
    lpips_params=fixture) on its draws (the regulariser fires at steps 0
    and 32)."""
    w, pw = world, patch_world
    rng = jax.random.PRNGKey(13)
    state = JState.create(w["params"], pw["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = pw["step"](state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    draws = _patch_draws(w, rng, step, N_RAYS * S)
    assert draws["inds"].shape == (N_RAYS,)
    tf, st, fn = _port(w, step, patch_size=P,
                       lpips_params=tlp.load_weights(FIXTURE))
    m = fn(st, w["tocc"], _tbatch(w["batch"]), draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["mse"]), float(jm["mse"]),
                               rtol=LOSS_RTOL)
    for name, p in tf.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        if not name.startswith("encoder_"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_patch_term_is_a_tenth_of_the_mean_lpips(world, monkeypatch):
    """The patch term adds 0.1 x the mean LPIPS of the rendered patches
    (in [-1, 1]) against the ground truth's, patch by patch: with LPIPS
    replaced by a spy returning 7 per patch, the loss rises by 0.7, and
    the spy saw [n_patch, 32, 32, 3] inputs. Without lpips_params no term
    is added."""
    from lzzx_nerf_tpu_torch.train import trainer

    seen = []

    def spy(params, x, y):
        seen.append((x.shape, float(x.detach().min()), float(y.max())))
        return torch.full((x.shape[0],), 7.0)

    monkeypatch.setattr(trainer.lpips_mod, "lpips", spy)
    g = torch.Generator().manual_seed(3)
    d = {"inds": patch_inds(RES, RES, 2048, P, g),
         "noise": torch.rand((2048,), generator=g),
         "eye_jitter": torch.rand((1,), generator=g)}
    w, loss = world, {}
    for name, lp in (("spy", {}), ("none", None)):
        tf, st, fn = _port(w, 1, patch_size=P, num_rays=2048,
                           lpips_params=lp)
        loss[name] = float(fn(st, w["tocc"], _tbatch(w["batch"]),
                              draws=d)["loss"])
    assert len(seen) == 1 and seen[0][0] == (2, P, P, 3)
    assert seen[0][1] >= -1.0 and seen[0][2] <= 1.0
    np.testing.assert_allclose(loss["spy"] - loss["none"], 0.7, rtol=1e-5)


def test_cli_patch_gate(tmp_path, monkeypatch):
    """--patch_size > 1 needs LPIPS weights: without an npz and without
    --allow_rand_lpips the CLI exits with the JAX CLI's message; with it,
    it trains and logs the weights' provenance (the JAX CLI's lines)."""
    from conftest import make_toy_dataset

    monkeypatch.delenv("LZZX_LPIPS_NPZ", raising=False)
    monkeypatch.setattr(tlp, "DEFAULT_WEIGHTS", str(tmp_path / "none.npz"))
    data = make_toy_dataset(tmp_path / "data")
    cfg = Config(path=data, workspace=str(tmp_path / "ws"),
                 asr_model="deepspeech", grid_size=32, max_steps=8,
                 num_rays=1024, iters=2, patch_size=P, train_budget_frac=0)
    with pytest.raises(SystemExit, match="allow_rand_lpips"):
        cli.run_train(cfg, "cpu")
    cfg2 = cfg.replace(allow_rand_lpips=True,
                       workspace=str(tmp_path / "ws2"))
    out = cli.run_train(cfg2, "cpu")
    assert out["state"].step == 2
    log = open(tmp_path / "ws2" / "log_ngp.txt").read()
    assert "RANDOM fixed-seed backbone" in log
    assert "--patch_size > 1 LPIPS weights" in log
