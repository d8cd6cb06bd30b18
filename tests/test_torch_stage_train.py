"""The staged training composite in the port (--train_stage_split,
render_rays_train_compact's stage_split) against the JAX package on the
CPU, at tests/test_train.py's sizes (48², grid 32, S 8, 1,024 rays, ray
budget 1,024, split 4).

- Staged against the single-pass compacted step (the port alone, one
  seeded draw): gradient-exact whenever the stage-2 budget holds every
  survivor (tests/test_train.py::test_staged_train_step_matches_compact):
  loss and mse rtol 2e-5 / atol 1e-7, the gradients to the step rule,
  the updated parameters rtol 5e-4 / atol 5e-5.
- Port against JAX on JAX's draws, with a stage-2 budget that overflows
  (128 slots, fewer than the survivors: those beyond them end at the
  split) and the default (0: effective_train_stage2_budget's 1,024): n_stage2 and n_stage2_over
  equal, loss rtol 2e-5, every gradient to the step rule, the updated
  parameters but the tables rtol 5e-4 / atol 5e-5
  (tests/test_torch_train_step.py's tolerances). The draws come from
  the step tests' key: at the ±1e-4 init the eye attention's first-layer
  gradient is about 6e-12, rounding-bound, and under another key (17)
  5 % of its entries leave the step rule in the single-pass compacted
  step as well (relative L2 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.render.renderer import \
    effective_train_stage2_budget as j_eff
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu_torch.render.renderer import \
    effective_train_stage2_budget
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (LOSS_RTOL, N_RAYS, PARAM_ATOL,
                                   PARAM_RTOL, S, _assert_grad_close,
                                   _jax_draws, _port, _tbatch, _tdraws,
                                   world)  # noqa: F401

SPLIT = S // 2


def test_effective_stage2_budget_matches_jax():
    for budget in (256, 1024, 2048, 4096, 49152):
        for s2 in (0, 256, 1024, 16384):
            assert effective_train_stage2_budget(budget, s2) == j_eff(
                budget, s2), (budget, s2)


@pytest.mark.parametrize("step", [1, 32])
def test_staged_step_matches_compact(world, step):
    """With every survivor slotted (stage-2 budget = ray budget), the
    staged step equals the single-pass compacted step up to float order:
    a sample past T < T_thresh adds nothing to any output, so its skipped
    field eval changes no gradient."""
    w = world
    d = _tdraws(_jax_draws(jax.random.PRNGKey(21), step, N_RAYS * S))
    out = {}
    for name, kw in (("compact", {}),
                     ("staged", dict(train_stage_split=SPLIT,
                                     train_stage2_budget=N_RAYS))):
        tf, st, fn = _port(w, step, train_budget=N_RAYS, **kw)
        m = fn(st, w["tocc"], _tbatch(w["batch"]), draws=d)
        out[name] = (m, {n: p.grad.clone() for n, p in tf.named_parameters()},
                     {n: p.detach().clone() for n, p in tf.named_parameters()})
    (mc, gc, pc), (ms, gs, ps) = out["compact"], out["staged"]
    assert "n_stage2" not in mc
    assert 0 < int(ms["n_stage2"]) <= N_RAYS
    assert int(ms["n_stage2_over"]) == int(ms["n_stage2"]) - N_RAYS
    for k in ("loss", "mse"):
        np.testing.assert_allclose(float(ms[k]), float(mc[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert int(ms["n_active"]) == int(mc["n_active"])
    for n in gc:
        _assert_grad_close(gs[n].numpy(), gc[n].numpy(), n)
        np.testing.assert_allclose(ps[n].numpy(), pc[n].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


@pytest.fixture(scope="module")
def staged_steps(world):
    w = world
    common = dict(w["common"], train_budget=N_RAYS,
                  train_stage_split=SPLIT)
    return {b: jax.jit(j_make_step(w["field"], w["jrs"], w["tx"],
                                   train_stage2_budget=b, **common))
            for b in (128, 0)}


@pytest.mark.parametrize("stage2,step", [(128, 1), (128, 32), (0, 32)])
def test_staged_step_matches_jax(world, staged_steps, stage2, step):
    """The staged compacted step against JAX's on its draws: the survivor
    demand and its overflow against the effective budget equal, the loss,
    mse, gradients and updated parameters within tolerance (128 truncates
    survivors at the split in both)."""
    w = world
    rng = jax.random.PRNGKey(3)
    state = JState.create(w["params"], w["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = staged_steps[stage2](state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    d = _tdraws(_jax_draws(rng, step, N_RAYS * S))
    tf, st, fn = _port(w, step, train_budget=N_RAYS,
                       train_stage_split=SPLIT, train_stage2_budget=stage2)
    m = fn(st, w["tocc"], _tbatch(w["batch"]), draws=d)
    for k in ("n_active", "n_active_over", "n_stage2", "n_stage2_over"):
        assert int(m[k]) == int(jm[k]), k
    if stage2 == 128:
        assert int(m["n_stage2_over"]) > 0
    else:
        assert int(m["n_stage2_over"]) <= 0
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


def test_cli_warns_on_survivor_overflow():
    """The CLI's step log warns when the survivors exceed the stage-2
    budget (the worst shard's slots under --data_parallel), and not
    otherwise."""
    from lzzx_nerf_tpu_torch import cli

    logs = []

    class Log:
        log = logs.append

        @staticmethod
        def scalar(*a):
            pass

    budgets = {"train_budget": 1024, "stage2": 1024, "split": 8,
               "sharded": False}
    m = {"loss": 0.1, "mse": 0.01, "n_active": 900, "n_active_over": -124,
         "n_stage2": 1500, "n_stage2_over": 476}
    cli._log_step(Log, m, 100, 0.0, 0, budgets)
    assert any("staged-eval survivor overflow: demand exceeds the "
               "stage-2 budget by 476 (demand 1500, budget 1024)" in ln
               and "truncate at sample 8" in ln for ln in logs)
    logs.clear()
    cli._log_step(Log, dict(m, n_stage2_over=-10), 100, 0.0, 0,
                  dict(budgets, sharded=True))
    assert not any("WARN" in ln for ln in logs)
    cli._log_step(Log, m, 100, 0.0, 0, dict(budgets, sharded=True))
    assert any("worst shard exceeds its stage-2 slots" in ln for ln in logs)
