"""The lips finetune in the port against the JAX package on the CPU: LPIPS
(train/lpips.py), the lips branch of the head step, the lips head losses
and the lips optimizer schedule, at the sizes of tests/test_train.py (48²,
grid 32, S 8), from the JAX field's own initial parameters and on JAX's
draws (fold_in(rng, step), split into rays/noise/reg/eye, as
make_train_step draws them).

Tolerances:
- random_params: bit-equal (the same numpy draws);
- LPIPS value rtol 1e-5 (float32 convolutions summed in another order)
  and its input gradient within 1e-4 of the gradient's largest entry;
  inputs are unequal, so that a transposed kernel or a wrong
  NHWC/NCHW permute cannot pass at distance 0;
- the lips step: loss rtol 2e-5; gradients to the rule of
  tests/test_torch_train_step.py (1e-3 relative + 1e-5 of the largest for
  all but 2 % of the entries, the 2 % for ReLU pre-activations within
  rounding of zero at the ±1e-4 table init, and 1e-2 in relative L2);
  updated parameters other than the tables rtol 5e-4 / atol 5e-5 (the
  tables through their gradients: Adam with b1 = 0 turns a near-zero
  gradient into a ±lr step);
- the lips head losses: value rtol 1e-6, gradients rtol 1e-5 / atol
  1e-10 (tests/test_torch_train_field.py's);
- the lips optimizer: lr factor rtol 1e-6 against optax's schedule,
  updates 1e-6 relative + 1e-8 absolute over three steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train import lpips as jlp
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.train.losses import head_losses as j_head_losses
from lzzx_nerf_tpu_torch.data import SyntheticTalkingHead
from lzzx_nerf_tpu_torch.serving.state_io import (params_from_jax,
                                                  params_to_jax)
from lzzx_nerf_tpu_torch.tools.train_production import lips_rects
from lzzx_nerf_tpu_torch.train import HeadOptimizer, head_losses
from lzzx_nerf_tpu_torch.train import lpips as tlp
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (ITERS, LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                   RES, _assert_grad_close, _capture,
                                   _port, _tbatch, world)  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "lpips_fixture.npz")
PAD = 32
LPIPS_RTOL, LPIPS_GRAD = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 3])
def test_random_params_bit_equal(seed):
    j = jlp.random_params(seed)
    t = tlp.random_params(seed)
    assert sorted(t) == sorted(j)
    for k, v in t.items():
        a = v.numpy()
        if k.startswith("conv"):
            a = a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        ref = np.asarray(j[k])
        assert a.dtype == ref.dtype and a.shape == ref.shape, k
        np.testing.assert_array_equal(a, ref, err_msg=k)


@pytest.mark.parametrize("which,res", [("fixture", 64), ("random", 32),
                                       ("random", 40)])
def test_lpips_value_and_input_gradient_match_jax(which, res):
    """Per-element distances and the gradient of their mean with respect
    to the first input, on unequal inputs (a batch of 2; 40 leaves an odd
    size at every pool)."""
    if which == "fixture":
        jp, tp = jlp.load_weights(FIXTURE), tlp.load_weights(FIXTURE)
    else:
        jp, tp = jlp.random_params(), tlp.random_params()
    rng = np.random.default_rng(res)
    x = rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    jd = np.asarray(jlp.lpips(jp, jnp.asarray(x), jnp.asarray(y)))
    jg = np.asarray(jax.grad(lambda a: jnp.mean(jlp.lpips(
        jp, a, jnp.asarray(y))))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    td = tlp.lpips(tp, xt, _t(y))
    td.mean().backward()
    assert td.shape == (2,) and (jd > 0).all()
    np.testing.assert_allclose(td.detach().numpy(), jd, rtol=LPIPS_RTOL)
    err = np.abs(xt.grad.numpy() - jg).max()
    assert err <= LPIPS_GRAD * np.abs(jg).max(), err
    # zero at identity, with a finite gradient
    xi = _t(x).requires_grad_(True)
    d0 = tlp.lpips(tp, xi, _t(x))
    d0.sum().backward()
    assert float(d0.detach().max()) < 1e-6
    assert torch.isfinite(xi.grad).all()


@pytest.mark.parametrize("shape", [(31, 31), (31, 32), (32, 31)])
def test_lpips_refuses_below_32(shape):
    """Below 32x32 the conv/pool stack collapses to nothing; both packages
    raise."""
    x = np.zeros((1, *shape, 3), np.float32)
    with pytest.raises(ValueError, match="32x32"):
        jlp.lpips(jlp.random_params(), jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="32x32"):
        tlp.lpips(tlp.random_params(), _t(x), _t(x))


def test_lpips_weights_resolution(tmp_path, monkeypatch):
    """get_params / is_pretrained / default_weights_path follow the JAX
    module's precedence: an explicit path must exist; else
    $LZZX_LPIPS_NPZ, then the cache default, then the fixed-seed random
    backbone."""
    monkeypatch.delenv("LZZX_LPIPS_NPZ", raising=False)
    monkeypatch.setattr(tlp, "DEFAULT_WEIGHTS", str(tmp_path / "none.npz"))
    assert tlp.default_weights_path() is None and not tlp.is_pretrained()
    r = tlp.get_params()
    assert torch.equal(r["conv0"], tlp.random_params()["conv0"])
    p = {k: np.asarray(v) for k, v in jlp.random_params(seed=3).items()}
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **p)
    monkeypatch.setenv("LZZX_LPIPS_NPZ", str(path))
    assert tlp.default_weights_path() == str(path) and tlp.is_pretrained()
    np.testing.assert_array_equal(
        tlp.get_params()["conv1"].numpy().transpose(2, 3, 1, 0), p["conv1"])
    bad = str(tmp_path / "typo.npz")
    assert not tlp.is_pretrained(bad)
    with pytest.raises(FileNotFoundError):
        tlp.get_params(bad)


def test_lips_head_losses_match_jax():
    """finetune_lips_active drops the uncertainty terms; value and
    gradients against JAX's, with the ambient terms on (step_factor 0.4)."""
    rng = np.random.default_rng(2)
    N = PAD * PAD
    pred = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    face = rng.uniform(size=N) < 0.6
    outs = {k: rng.uniform(0, 1, N).astype(np.float32)
            for k in ("ambient_aud", "ambient_eye", "uncertainty",
                      "weights_sum")}
    keys = sorted(outs)

    def jl(p, o):
        return j_head_losses(dict(zip(keys, o)), p, jnp.asarray(gt),
                             jnp.asarray(face), jnp.float32(0.4),
                             max_steps=8, finetune_lips_active=True)

    jv, (jgp, jgo) = jax.value_and_grad(jl, argnums=(0, 1))(
        jnp.asarray(pred), [jnp.asarray(outs[k]) for k in keys])
    tp = _t(pred).requires_grad_(True)
    to = [_t(outs[k]).requires_grad_(True) for k in keys]
    tv = head_losses(dict(zip(keys, to)), tp, _t(gt), _t(face), 0.4,
                     max_steps=8, finetune_lips_active=True)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-5,
                               atol=1e-10)
    for k, t, j in zip(keys, to, jgo):
        g = t.grad.numpy() if t.grad is not None else np.zeros_like(j)
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-5, atol=1e-10,
                                   err_msg=k)
    assert not np.asarray(jgo[keys.index("uncertainty")]).any()


def test_lips_optimizer_schedule_matches_optax(world):
    """finetune_lips=True: lr factor 0.05 ** (count / iters) against
    optax.exponential_decay, and three updates against
    build_optimizer(finetune_lips=True)."""
    iters = 4
    tf, _, _ = _port(world)
    opt = HeadOptimizer(tf.named_parameters(), 1e-2, 1e-3, iters,
                        finetune_lips=True)
    sched = optax.exponential_decay(init_value=1.0, transition_steps=iters,
                                    decay_rate=0.05)
    for c in (0, 1, 3, 4, 7, 40):
        np.testing.assert_allclose(
            float(opt.lr_factor(torch.tensor(c, dtype=torch.int32))),
            float(sched(c)), rtol=1e-6, err_msg=str(c))
    tx = build_optimizer(1e-2, 1e-3, iters, finetune_lips=True)
    inner = jax.tree.map(jnp.asarray, world["params"]["params"])
    st = tx.init(inner)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = {n: (rng.normal(size=p.shape) * 1e-3).astype(np.float32)
             for n, p in tf.named_parameters()}
        for n, p in tf.named_parameters():
            p.grad = _t(g[n])
        opt.step()
        jg = jax.tree.map(jnp.asarray, params_to_jax(
            {n: _t(v) for n, v in g.items()}))
        u, st = update(jg, st, inner)
        inner = optax.apply_updates(inner, u)
    ref = params_from_jax(jax.tree.map(np.asarray, inner))
    for n, p in tf.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=n)


@pytest.fixture(scope="module")
def lips_world(world):
    """The JAX lips steps (full path, and with a compaction budget that
    the lips finetune must ignore) and the frame with its lips rect."""
    w = world
    ds = SyntheticTalkingHead(num_frames=8, H=RES, W=RES)
    rect = lips_rects(ds, RES, PAD)[0]
    jlp_params = jlp.load_weights(FIXTURE)
    tx = _capture(build_optimizer(lr=1e-2, lr_net=1e-3, iters=ITERS,
                                  finetune_lips=True))
    kw = dict(w["common"], finetune_lips=True, lips_pad=PAD,
              lpips_params=jlp_params)
    steps = {b: jax.jit(j_make_step(w["field"], w["jrs"], tx,
                                    train_budget=b, **kw))
             for b in (0, 256)}
    batch = dict(w["batch"], rect_origin=np.asarray(rect, np.int32))
    return dict(rect=rect, tx=tx, steps=steps, batch=batch)


def _lips_draws(rng, step):
    k = jax.random.fold_in(rng, step)
    _, r_noise, _, r_eye = jax.random.split(k, 4)
    return {"noise": torch.from_numpy(np.array(jax.random.uniform(
                r_noise, (PAD * PAD,)))),
            "eye_jitter": torch.from_numpy(np.array(jax.random.uniform(
                r_eye, (1,))))}


@pytest.mark.parametrize("budget,step", [(0, 0), (0, 5), (256, 5)])
def test_lips_step_matches_jax(world, lips_world, budget, step):
    """Loss, mse, every gradient and the updated parameters after one lips
    step against JAX's make_train_step(finetune_lips=True, lips_pad=32,
    lpips_params=fixture) on the same draws: the rays are the 32² crop at
    the lips rect, no uncertainty terms, no regulariser, 0.01 x LPIPS of
    the crop; a compaction budget is ignored (the full path) in both."""
    w, lw = world, lips_world
    oy, ox = lw["rect"]
    assert 0 < oy <= RES - PAD and 0 < ox <= RES - PAD
    rng = jax.random.PRNGKey(7)
    state = JState.create(w["params"], lw["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in lw["batch"].items()}
    js, jm = lw["steps"][budget](state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    tf, st, fn = _port(w, step, finetune_lips=True, lips_pad=PAD,
                       lpips_params=tlp.load_weights(FIXTURE),
                       train_budget=budget)
    st.opt = HeadOptimizer(tf.named_parameters(), 1e-2, 1e-3, ITERS,
                           finetune_lips=True)
    m = fn(st, w["tocc"], _tbatch(lw["batch"]),
           draws=_lips_draws(rng, step))
    assert st.step == step + 1 and "n_active" not in m
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["mse"]), float(jm["mse"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["lr_factor"], float(jm["lr_factor"]),
                               rtol=1e-6)
    for name, p in tf.named_parameters():
        ref = jgrads[name].numpy()
        # unc_net feeds no lips loss term: no gradient reaches it (zeros in
        # JAX)
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        assert p.grad is not None or name.startswith("unc_net"), name
        _assert_grad_close(g, ref, name)
        if not name.startswith("encoder_"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_lips_step_lpips_term(world, lips_world, monkeypatch):
    """The lips step adds 0.01 x mean LPIPS of the crop, pred and target
    mapped to [-1, 1] and shaped [1, 32, 32, 3] (shifted here by a
    constant so that the term shows beside the float32 loss); without
    lpips_params there is no LPIPS term."""
    from lzzx_nerf_tpu_torch.train import trainer

    w, lw = world, lips_world
    seen = []
    real = tlp.lpips

    def spy(params, x, y):
        seen.append((x.detach().clone(), y.detach().clone()))
        return real(params, x, y) + 3.0

    d = _lips_draws(jax.random.PRNGKey(8), 0)
    losses = {}
    for name, lp in (("spy", tlp.load_weights(FIXTURE)), ("none", None)):
        monkeypatch.setattr(trainer.lpips_mod, "lpips", spy)
        tf, st, fn = _port(w, 0, finetune_lips=True, lips_pad=PAD,
                           lpips_params=lp)
        losses[name] = float(fn(st, w["tocc"], _tbatch(lw["batch"]),
                                draws=d)["loss"])
    assert len(seen) == 1
    x, y = seen[0]
    assert x.shape == y.shape == (1, PAD, PAD, 3)
    oy, ox = lw["rect"]
    img = lw["batch"]["image"][oy:oy + PAD, ox:ox + PAD]
    np.testing.assert_allclose(y[0].numpy(), img * 2 - 1, atol=1e-6)
    lp = float(real(tlp.load_weights(FIXTURE), x, y)[0])
    np.testing.assert_allclose(losses["spy"] - losses["none"],
                               0.01 * (lp + 3.0), rtol=1e-4)


def test_lips_run_starts_from_the_head():
    """The recipe's lips stage (LipsRun): the JAX script's oracle lips rect
    per frame, a step count restarted at 0 (step_factor restarts), the
    EMA seeded from the head's EMA (not its parameters), the head's
    parameters trained in place at the 0.05 decay, and finish() handing
    the EMA back to the head."""
    from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
    from lzzx_nerf_tpu_torch.tools.train_production import HeadRun, LipsRun

    run = HeadRun(res=48, grid=32, frames=4, num_rays=1024, warmup=2,
                  head_iters=10, eval_res=32, device="cpu")
    for it in range(3):
        run.step(it)
    with torch.no_grad():
        for e in run.state.ema.values():
            e.add_(0.5)          # an EMA unlike the parameters
    ema0 = {n: e.clone() for n, e in run.state.ema.items()}
    lips = LipsRun(run, 20, PAD, tlp.random_params())
    ds = JData(num_frames=4, H=48, W=48, torso=True)
    for i, b in enumerate(lips.frames):
        r_pix = ds.intrinsics[0] * ds.radius(i) / ds.cam_dist
        want = (int(min(48 - PAD, 48 / 2 + 0.25 * r_pix)),
                int(48 / 2 - PAD / 2))
        assert tuple(b["rect_origin"].tolist()) == want
    assert run.state.step == 3 and lips.state.step == 0
    assert lips.opt.decay_rate == 0.05 and lips.opt.iters == 20
    assert lips.state.field is run.field
    for n, e in lips.state.ema.items():
        assert torch.equal(e, ema0[n]) and e is not run.state.ema[n]
    w0 = run.field.sigma_net.net_0.weight.detach().clone()
    m = lips.step(0)
    assert lips.state.step == 1 and np.isfinite(float(m["loss"]))
    assert not torch.equal(run.field.sigma_net.net_0.weight, w0)
    lips.finish()
    assert run.state.ema is lips.state.ema
