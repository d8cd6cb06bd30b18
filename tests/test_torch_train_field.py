"""The head training slice's model, losses, optimizer, checkpoint layout
and entry point in the port, against the JAX package on the CPU where it
has a counterpart; and a 240-step training loop of the port alone.

Tolerances: field outputs within 1e-6 absolute (sigma 1e-5 relative) and
every parameter gradient within 1e-4 relative + 1e-5 of the largest
entry; head loss value 1e-6 relative and its gradients 1e-5 relative
(1e-10 absolute); optimizer steps 1e-6 relative and 1e-8 absolute (a
millionth of the step lr = 1e-2: Adam's bias correction 1 - 0.99^count
comes from pow, which rounds differently in the two libraries in about 1
count of 70) against optax over several steps; the checkpoint round trip
and the skipped step exact.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train.losses import head_losses as j_head_losses
from lzzx_nerf_tpu.train.optim import param_label_fn as j_label
from lzzx_nerf_tpu_torch.data import SyntheticTalkingHead
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.render import (RenderSettings, init_occupancy_state,
                                        make_density_grid_update)
from lzzx_nerf_tpu_torch.serving.state_io import (params_from_jax,
                                                  params_to_jax)
from lzzx_nerf_tpu_torch.tools import train_production
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, PSNRMeter, TrainState,
                                       head_losses, make_eval_step,
                                       make_train_step, param_label_fn, psnr)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

RES = 48
GRID = 32


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jworld():
    ds = JData(num_frames=8, H=RES, W=RES)
    field = JField(audio_in_dim=ds.audio_dim, ind_num=64)
    b0 = ds.frame(0)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3)) / 3 ** 0.5,
        jnp.asarray(b0["auds"]), jnp.zeros(4), jnp.asarray([0.2]),
        method="init_all")
    return ds, field, jax.tree.map(np.asarray, params)


def _port_field(jw):
    ds, _, params = jw
    tf = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64)
    tf.load_state_dict(params_from_jax(params))
    return tf


def test_field_outputs_and_gradients_match_jax(jworld):
    """NeRFField's training forward (audio path, triplane bake and lookup,
    density, colour, detached uncertainty) and the gradient of every
    parameter against jax.grad, on JAX's own initial parameters."""
    ds, jf, params = jworld
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.1, 1.1, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    auds = ds.frame(2)["auds"]
    e = np.float32([0.3])
    wts = (1.0, 0.3, 0.7, 1.1, 0.5)

    def jloss(p):
        ea = jf.apply(p, jnp.asarray(auds), method="encode_audio")
        o = jf.apply(p, jnp.asarray(pts), jnp.asarray(d), ea,
                     p["params"]["individual_codes"][3], jnp.asarray(e))
        return sum(jnp.sum(x * w) for x, w in zip(o, wts)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tf = _port_field(jworld)
    ea = tf.encode_audio_train(_t(auds))
    to = tf(_t(pts), _t(d), ea, tf.individual_codes[3], _t(e))
    sum(torch.sum(x * w) for x, w in zip(to, wts)).backward()

    np.testing.assert_allclose(to.sigma.detach().numpy(),
                               np.asarray(jo.sigma), rtol=1e-5)
    for k in ("color", "ambient_aud", "ambient_eye", "uncertainty"):
        np.testing.assert_allclose(getattr(to, k).detach().numpy(),
                                   np.asarray(getattr(jo, k)), atol=1e-6,
                                   err_msg=k)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tf.named_parameters():
        ref = jgrads[name].numpy()
        tol = 1e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert np.all(np.abs(p.grad.numpy() - ref) <= tol), name
    # unc_net sees a detached encoding: no gradient reaches the tables
    # through it
    assert tf.unc_net.net_0.weight.grad.abs().sum() > 0


def _init_bound(name, p):
    """The JAX package's initialiser bound of a parameter: tables ±1e-4,
    kernels ±1/sqrt(shape[0] of the flax kernel), i.e. the fan-in of a
    Dense and the width 3 of a Conv."""
    if name.startswith("encoder_"):
        return 1e-4
    return 1.0 / np.sqrt(p.shape[2] if p.ndim == 3 else p.shape[1])


def test_init_params_schemes(jworld):
    """init_params draws the JAX package's initialisers from a generator:
    both packages' draws lie within each scheme's bound and (for tensors
    of 256 entries or more) reach 0.9 of it; biases are zero, individual
    codes have spread 0.1; one seed gives one draw."""
    ds, _, params = jworld
    a = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(3))
    b = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(3))
    ref = params_from_jax(params)
    for name, p in a.named_parameters():
        assert torch.equal(p, dict(b.named_parameters())[name])
        x, r = p.detach().numpy(), ref[name].numpy()
        assert x.shape == r.shape, name
        if name.endswith(".bias"):
            assert not x.any() and not r.any(), name
        elif name == "individual_codes":
            assert abs(x.std() - 0.1) < 0.02 and abs(r.std() - 0.1) < 0.02
        else:
            bound = _init_bound(name, p) * (1 + 1e-6)
            for v in (x, r):
                assert np.abs(v).max() <= bound, name
                assert v.size < 256 or np.abs(v).max() > 0.9 * bound, name


def test_head_losses_match_jax():
    """head_losses' value and gradients, with and without the compact
    path's ray weights (0 for overflow rays, >= 1 for slotted ones)."""
    rng = np.random.default_rng(1)
    N = 512
    pred = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    face = rng.uniform(size=N) < 0.4
    outs = {"uncertainty": rng.uniform(0, 2, N).astype(np.float32),
            "weights_sum": rng.uniform(0, 1, N).astype(np.float32),
            "ambient_aud": rng.uniform(0, 1, N).astype(np.float32),
            "ambient_eye": rng.uniform(0, 1, N).astype(np.float32)}
    outs["weights_sum"][:20] = 0.0
    rw = np.where(rng.uniform(size=N) < 0.2, 0.0, 1.3).astype(np.float32)
    keys = sorted(outs)
    for sf, ray_weight in ((0.3, None), (0.7, rw), (0.0, rw)):
        def jl(p, o):
            return j_head_losses(dict(zip(keys, o)), p, jnp.asarray(gt),
                                 jnp.asarray(face), jnp.float32(sf),
                                 max_steps=16,
                                 ray_weight=None if ray_weight is None
                                 else jnp.asarray(ray_weight))
        jv, (jgp, jgo) = jax.value_and_grad(jl, argnums=(0, 1))(
            jnp.asarray(pred), [jnp.asarray(outs[k]) for k in keys])
        tp = _t(pred).requires_grad_(True)
        to = [_t(outs[k]).requires_grad_(True) for k in keys]
        tv = head_losses(dict(zip(keys, to)), tp, _t(gt), _t(face), sf,
                         max_steps=16,
                         ray_weight=None if ray_weight is None
                         else _t(ray_weight))
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp),
                                   rtol=1e-5, atol=1e-10)
        for k, t, j in zip(keys, to, jgo):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       rtol=1e-5, atol=1e-10, err_msg=k)


def test_param_groups_match_jax(jworld):
    _, _, params = jworld
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        name = ".".join(keys[:-1] + (["weight"] if keys[-1] == "kernel"
                                     else keys[-1:]))
        names[name] = j_label(path, leaf)
    tf = _port_field(jworld)
    got = {n: param_label_fn(n) for n, _ in tf.named_parameters()}
    assert got == names
    assert set(got.values()) == {"grid", "att", "net"}


def _opt_pair(jworld, iters, max_errors=100):
    _, _, params = jworld
    tf = _port_field(jworld)
    logs = []
    opt = HeadOptimizer(tf.named_parameters(), 1e-2, 1e-3, iters,
                        max_consecutive_errors=max_errors, log=logs.append)
    return tf, opt, logs


def _grads(tf, seed, nan=False):
    rng = np.random.default_rng(seed)
    g = {}
    for n, p in tf.named_parameters():
        x = rng.normal(size=p.shape).astype(np.float32) * 1e-3
        if nan and n == "sigma_net.net_1.weight":
            x[0, 0] = np.nan
        g[n] = x
    return g


def _set_grads(tf, g):
    for n, p in tf.named_parameters():
        p.grad = _t(g[n])


def _jtree(g):
    return jax.tree.map(jnp.asarray, params_to_jax(
        {n: _t(v) for n, v in g.items()}))


def test_optimizer_matches_optax(jworld):
    """Three steps per group against optax (schedule over iters=4, so step
    k > 0 runs at lr x 0.5^(k/4)), then a step with one nan gradient: no
    parameter, moment or schedule count moves, the skip is logged, and
    the next finite step equals optax's."""
    tf, opt, logs = _opt_pair(jworld, iters=4)
    tx = build_optimizer(1e-2, 1e-3, 4)
    inner = jax.tree.map(jnp.asarray, jworld[2]["params"])
    st = tx.init(inner)
    update = jax.jit(tx.update)
    for k, nan in enumerate((False, False, False, True, False)):
        g = _grads(tf, k, nan)
        _set_grads(tf, g)
        before = {n: p.detach().clone() for n, p in tf.named_parameters()}
        nu_before = {n: v.clone() for n, v in opt.state_dict()["nu"].items()}
        count_before = int(opt.count)
        opt.step()
        u, st = update(_jtree(g), st, inner)
        inner = optax.apply_updates(inner, u)
        ref = params_from_jax(jax.tree.map(np.asarray, inner))
        for n, p in tf.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                       rtol=1e-6, atol=1e-8, err_msg=n)
        if nan:
            assert int(opt.count) == count_before == 3
            for n, p in tf.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
                assert torch.equal(opt.state_dict()["nu"][n], nu_before[n])
            assert opt.poll(k + 1) == (1, 1)
            assert any("[WARN]" in m and "skipped" in m for m in logs)
            assert int(st.total_notfinite) == 1
        adam, _, sched = st.inner_state.inner_states["grid"].inner_state
        assert int(opt.count) == int(adam.count) == int(sched.count)
    assert int(opt.count) == 4 and opt.poll(5) == (1, 0)
    np.testing.assert_allclose(float(opt.lr_factor()), 0.5, rtol=1e-7)


def test_optimizer_backstop_applies_and_warns(jworld):
    """optax.apply_if_finite's backstop: once the consecutive bad steps
    exceed max_consecutive_errors the non-finite update applies (here the
    third of three with max 2), and poll() says so loudly."""
    tf, opt, logs = _opt_pair(jworld, iters=10, max_errors=2)
    w0 = tf.sigma_net.net_1.weight.detach().clone()
    for k in range(3):
        _set_grads(tf, _grads(tf, 10 + k, nan=True))
        opt.step()
        w = tf.sigma_net.net_1.weight.detach()
        if k < 2:
            assert torch.equal(w, w0) and int(opt.count) == 0
    assert torch.isnan(w[0, 0]) and not torch.isnan(w[0, 1])
    assert int(opt.count) == 1 and opt.poll(3) == (3, 3)
    assert any("APPLIED" in m for m in logs)


def test_params_to_jax_inverts_params_from_jax(jworld):
    _, _, params = jworld
    back = params_to_jax(params_from_jax(params))
    ja = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    jb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ja] == [p for p, _ in jb]
    for (path, a), (_, b) in zip(ja, jb):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_entry_point_refuses_without_gpu_and_unported_stages(tmp_path):
    """Without a GPU the default device raises, whichever stages run (the
    lips and torso stages are ported now: nothing else refuses)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    for stages in (["--lips-iters", "0", "--torso-iters", "0"],
                   ["--lips-iters", "1", "--torso-iters", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_production.main(["--workspace", str(tmp_path), "--res",
                                   "32", "--grid", "32", "--head-iters", "1",
                                   *stages])
    assert not os.listdir(tmp_path)


def test_entry_point_tiny_cpu_run_writes_a_jax_loadable_head(jworld,
                                                             tmp_path):
    """A tiny CPU run (full-path warm-up, then compacted steps, a grid
    refresh every 16) writes the JSON lines and ckpt_head.pkl; the JAX
    NeRFField loads the checkpoint's parameters and renders the port's
    outputs."""
    ws = tmp_path / "ws"
    rc = train_production.main([
        "--device", "cpu", "--res", "32", "--grid", "32", "--frames", "4",
        "--num-rays", "2048", "--head-iters", "12", "--warmup", "6",
        "--eval-every", "12", "--eval-res", "24", "--log-every", "6",
        "--ckpt-every", "12", "--lips-iters", "0", "--torso-iters", "0",
        "--workspace", str(ws)])
    assert rc == 0
    lines = [json.loads(x) for x in open(ws / "metrics.jsonl")]
    events = [x["event"] for x in lines]
    # the head stage, then the recipe's end with no lips and no torso step
    assert events == ["start", "log", "log", "eval", "stage_done", "start",
                      "stage_done", "eval_final", "done"]
    assert lines[0]["train_budget"] == 1024
    assert lines[1]["n_active"] == 0 and lines[2]["n_active"] > 0
    assert all(x["grad_notfinite"] == 0 for x in lines if "loss" in x)
    with open(ws / "ckpt_head.pkl", "rb") as f:
        ck = pickle.load(f)
    assert ck["it"] == 12 and int(ck["state"]["step"]) == 12
    assert set(ck["occ"]) == {"density_grid", "occ", "mean_density",
                              "iter_density", "density_grid_torso",
                              "mean_density_torso"}
    tree = ck["state"]["params"]["params"]
    ref = jworld[2]["params"]
    assert (jax.tree.structure(tree) == jax.tree.structure(ref))
    jf = JField(audio_in_dim=jworld[0].audio_dim, ind_num=64)
    jp = {"params": jax.tree.map(jnp.asarray, tree)}
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = np.tile(np.float32([0, 0, 1]), (64, 1))
    auds = SyntheticTalkingHead(num_frames=4, H=32, W=32).frame(1)["auds"]
    ea = jf.apply(jp, jnp.asarray(auds), method="encode_audio")
    jo = jf.apply(jp, jnp.asarray(pts), jnp.asarray(d), ea,
                  jp["params"]["individual_codes"][0], jnp.asarray([0.2]))
    tf = NeRFField(audio_in_dim=jworld[0].audio_dim, ind_num=64)
    tf.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        to = tf(_t(pts), _t(d), tf.encode_audio(_t(auds)),
                tf.individual_codes[0], _t(np.float32([0.2])))
    np.testing.assert_allclose(to.sigma.numpy(), np.asarray(jo.sigma),
                               rtol=1e-5)
    np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color),
                               atol=1e-6)


def test_port_train_loop_improves_psnr():
    """test_train.py's criteria for the port alone: 240 full-path steps at
    48² from the seeded init (everything occupied at the start, a grid
    refresh every 60 steps): the loss of the last 30 steps averages under
    0.8 of the first 30's, and the eval PSNR rises by at least 2 dB."""
    ds = SyntheticTalkingHead(num_frames=8, H=RES, W=RES)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=GRID,
                              max_steps=8, dt=2 * 3 ** 0.5 / GRID,
                              num_cand=28)
    occ = init_occupancy_state(settings)
    occ = occ._replace(occ=torch.ones_like(occ.occ))
    field = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(0))
    opt = HeadOptimizer(field.named_parameters(), 1e-2, 1e-3, 2000)
    state = TrainState.create(field, opt)
    step = make_train_step(field, settings, H=RES, W=RES,
                           intrinsics=ds.intrinsics, num_rays=1024,
                           iters=2000, ind_dim=4, ema_interval=50,
                           update_extra_interval=16)
    evaluate = make_eval_step(field, settings, H=RES, W=RES,
                              intrinsics=ds.intrinsics)
    refresh = make_density_grid_update(field, settings)
    batches = [{k: int(v) if k == "index" else _t(v)
                for k, v in ds.frame(f).items()} for f in range(8)]
    meter = PSNRMeter()
    meter.update(evaluate(state, occ, batches[0])["image"],
                 batches[0]["image"])
    before = meter.measure()
    gen = torch.Generator().manual_seed(1)
    losses = []
    for it in range(240):
        b = batches[it % 8]
        losses.append(float(step(state, occ, b, gen)["loss"]))
        if (it + 1) % 60 == 0:
            occ = refresh(occ, b["auds"], b["eye"], gen)
    after = float(psnr(evaluate(state, occ, batches[0])["image"],
                       batches[0]["image"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-30:]) < np.mean(losses[:30]) * 0.8, (
        np.mean(losses[:30]), np.mean(losses[-30:]))
    assert after > before + 2.0, (before, after)
    assert state.step == 240 and opt.poll(240) == (0, 0)
