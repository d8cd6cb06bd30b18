"""The port's head training step against the JAX package's on the CPU, on
the same draws, at the sizes of tests/test_train.py (48², grid 32, 1,024
rays, S 8), from the JAX field's own initial parameters.

The draws are made with JAX exactly as make_train_step makes them
(fold_in(rng, step), split into rays/noise/reg/eye) and handed to the
port's step. The JAX step runs with its real optimizer wrapped so that the
optimizer state also keeps the gradients.

Tolerances:
- loss and mse: rtol 2e-5 (float32, sums in another order);
- gradients: per parameter, |g - g_jax| <= 1e-3 |g_jax| + 1e-5 max|g_jax|
  (scatter-add sums over thousands of samples in another order; the tail
  term covers entries that cancel to near zero) for all but 2 % of the
  entries, and the whole gradient within 1e-2 in relative L2 norm. The
  exempt entries belong to samples with a ReLU pre-activation within float
  rounding of zero: at the ±1e-4 table init the first layers see inputs of
  1e-4 and pre-activations of 1e-10 occur, whose sign the other summation
  order may flip. Observed: one sample of 8,192 at step 0; its flip moves
  one table row per plane and one hidden unit's 36 input weights of
  aud_ch_att_net (1.6 % of that matrix);
- updated parameters: tests/test_train.py's rtol 5e-4 / atol 5e-5 for
  every group but the triplane tables. Adam with b1 = 0 turns a first
  step's gradient into lr * g / (|g| + eps): a table entry whose gradient
  is a few eps in size, or cancels to a different near-zero value under
  another summation order, moves by up to lr (1e-2) in either package.
  The tables are held through their gradients instead (above);
- n_active, ray_weight and the sample masks: equal;
- the jitter regulariser alone: value rtol 1e-5, gradients as above.

The steps run at step 0 (the regulariser fires, but step_factor 0 weighs
it and the uncertainty and ambient losses at 0), step 1 (the regulariser
is off) and step 32 (it fires, with step_factor 0.32 on every term). A
term scaled by 1e-5 is lost inside the whole gradient's tolerance, so the
regulariser is also held alone against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models.nerf import FieldOutputs as JOut
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render.renderer import render_rays as j_render
from lzzx_nerf_tpu.render.renderer import \
    render_rays_train_compact as j_render_compact
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.train.trainer import _masked_mse as j_masked_mse
from lzzx_nerf_tpu_torch.models import FieldOutputs, NeRFField
from lzzx_nerf_tpu_torch.render import (OccupancyState, RenderSettings,
                                        render_rays, render_rays_train_compact)
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                       jitter_regulariser, make_eval_step,
                                       make_train_step)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

GRID = 32
RES = 48
N_RAYS = 1024
S = 8
ITERS = 100
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_TAIL = 1e-3, 1e-5
GRAD_EXEMPT, GRAD_L2 = 2e-2, 1e-2
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-5


def _capture(inner):
    """inner, with the gradients of the last update kept in its state."""
    def init(p):
        return (jax.tree.map(jnp.zeros_like, p), inner.init(p))

    def update(g, s, p=None):
        u, s2 = inner.update(g, s[1], p)
        return u, (g, s2)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def world():
    ds = JData(num_frames=8, H=RES, W=RES)
    jrs = JRS(bound=1.0, cascade=1, grid_size=GRID, max_steps=S,
              dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    trs = RenderSettings(bound=1.0, cascade=1, grid_size=GRID, max_steps=S,
                         dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    field = JField(audio_in_dim=ds.audio_dim, att=2, exp_eye=True,
                   ind_dim=4, ind_num=64)
    b0 = ds.frame(0)
    params = field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3)) / 3 ** 0.5,
        jnp.asarray(b0["auds"]), jnp.zeros(4), jnp.asarray([0.2]),
        method="init_all")
    # the sphere occupancy of test_compact_train_step_matches_full: a mix
    # of active and inactive rays
    r = jnp.linspace(-1, 1, GRID)
    X, Y, Z = jnp.meshgrid(r, r, r, indexing="ij")
    jocc = j_init_occ(jrs)._replace(
        occ=(jnp.sqrt(X ** 2 + Y ** 2 + Z ** 2) < 0.45)[None])
    tocc = OccupancyState(**{k: torch.from_numpy(np.array(v))
                             for k, v in jocc._asdict().items()})
    tx = _capture(build_optimizer(lr=1e-2, lr_net=1e-3, iters=ITERS))
    common = dict(H=RES, W=RES, intrinsics=ds.intrinsics, num_rays=N_RAYS,
                  iters=ITERS, ind_dim=4, ema_interval=50)
    steps = {"full": jax.jit(j_make_step(field, jrs, tx, **common)),
             "compact": jax.jit(j_make_step(field, jrs, tx,
                                            train_budget=N_RAYS, **common))}
    batch = ds.frame(0)
    return dict(ds=ds, jrs=jrs, trs=trs, field=field, params=params,
                jocc=jocc, tocc=tocc, tx=tx, steps=steps, common=common,
                batch=batch)


def _assert_grad_close(g, ref, name):
    tol = GRAD_RTOL * np.abs(ref) + GRAD_TAIL * np.abs(ref).max()
    bad = int((np.abs(g - ref) > tol).sum())
    assert bad <= GRAD_EXEMPT * ref.size, (name, bad, ref.size)
    err = np.linalg.norm(g - ref)
    assert err <= GRAD_L2 * max(np.linalg.norm(ref), 1e-30), (name, err)


def _jax_draws(rng, step, pts_rows, eye_shape=(1,)):
    k = jax.random.fold_in(rng, step)
    r_rays, r_noise, r_reg, r_eye = jax.random.split(k, 4)
    return {"inds": np.asarray(jax.random.randint(r_rays, (N_RAYS,), 0,
                                                  RES * RES)),
            "noise": np.asarray(jax.random.uniform(r_noise, (N_RAYS,))),
            "eye_jitter": np.asarray(jax.random.uniform(r_eye, eye_shape)),
            "reg_delta": np.asarray(jax.random.uniform(r_reg,
                                                       (pts_rows, 3)))}


def _port(w, step=0, **kw):
    tf = NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64)
    tf.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                    w["params"])))
    opt = HeadOptimizer(tf.named_parameters(), 1e-2, 1e-3, ITERS)
    st = TrainState.create(tf, opt)
    st.step = step
    fn = make_train_step(tf, w["trs"], **{**w["common"], **kw})
    return tf, st, fn


def _tbatch(b):
    return {k: (int(v) if k == "index" else torch.from_numpy(np.array(v)))
            for k, v in b.items()}


def _tdraws(d):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k == "inds" else torch.float32) for k, v in d.items()}


@pytest.mark.parametrize("path,step", [("full", 0), ("full", 1),
                                       ("full", 32), ("compact", 0),
                                       ("compact", 1), ("compact", 32)])
def test_train_step_matches_jax(world, path, step):
    """Loss, every gradient and the updated parameters after one step, at
    step 0 (the jitter regulariser fires at weight 0), step 1 (it does
    not fire) and step 32 (it fires at weight 0.32 * 1e-5)."""
    w = world
    budget = N_RAYS if path == "compact" else 0
    rng = jax.random.PRNGKey(3)
    state = JState.create(w["params"], w["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = w["steps"][path](state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    draws = _jax_draws(rng, step, (budget or N_RAYS) * S)
    tf, st, fn = _port(w, step, train_budget=budget)
    m = fn(st, w["tocc"], _tbatch(w["batch"]), draws=_tdraws(draws))

    assert st.step == step + 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["mse"]), float(jm["mse"]),
                               rtol=LOSS_RTOL)
    if budget:
        assert int(m["n_active"]) == int(jm["n_active"])
        assert int(m["n_active_over"]) == int(jm["n_active_over"])
    for name, p in tf.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        if not name.startswith("encoder_"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_jitter_regulariser_matches_jax(world):
    """The regulariser's value and the gradient of every parameter against
    JAX's (the closure `reg` of its make_train_step, restated over
    field.apply), on the same samples, mask and jitter. The tables are
    drawn in ±0.5 instead of ±1e-4: at the init scale the outputs at pts
    and pts + delta differ by float rounding, and the test would compare
    noise."""
    w = world
    rng = np.random.default_rng(11)
    M = 2048
    params = jax.tree.map(np.asarray, w["params"])
    inner = dict(params["params"])
    for k in sorted(inner):
        if k.startswith("encoder_"):
            inner[k] = rng.uniform(-0.5, 0.5, inner[k].shape).astype(
                np.float32)
    params = {**params, "params": inner}
    pts = rng.uniform(-0.6, 0.6, (M, 3)).astype(np.float32)
    dirs = rng.normal(size=(M, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mask = rng.uniform(size=M) < 0.7
    delta = ((rng.uniform(size=(M, 3)) * 2 - 1) * 1e-3).astype(np.float32)
    b = w["batch"]
    eye = np.asarray(b["eye"], np.float32) + np.float32(0.02)
    field = w["field"]

    def j_reg(p):
        enc_a = field.apply(p, jnp.asarray(b["auds"]),
                            method="encode_audio")
        ea = jax.lax.stop_gradient(enc_a)
        cc = jax.lax.stop_gradient(
            p["params"]["individual_codes"][int(b["index"])])
        raw = jax.lax.stop_gradient(field.apply(p, pts, dirs, ea, cc, eye))
        per = field.apply(p, pts + delta, dirs, ea, cc, eye)
        return (j_masked_mse(raw.uncertainty, per.uncertainty, mask)
                + j_masked_mse(raw.ambient_aud, per.ambient_aud, mask)
                + j_masked_mse(raw.ambient_eye, per.ambient_eye, mask))

    jv, jg = jax.value_and_grad(j_reg)(params)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jg))

    tf = NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64)
    tf.load_state_dict(params_from_jax(params))
    tb = _tbatch(b)
    reg = jitter_regulariser(
        tf, _t(pts), _t(dirs), _t(mask), tf.encode_audio_train(tb["auds"]),
        tf.individual_codes[tb["index"]], _t(eye), _t(delta),
        tf.bake_train_tables())
    reg.backward()
    assert float(jv) > 0
    np.testing.assert_allclose(float(reg.detach()), float(jv), rtol=1e-5)
    moved = set()
    for name, p in tf.named_parameters():
        ref = jgrads[name].numpy()
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros_like(ref))
        _assert_grad_close(g, ref, name)
        if np.abs(ref).max() > 0:
            moved.add(name.split(".")[0])
    # the regulariser reaches the tables and the three attention/uncertainty
    # nets, and nothing else
    assert moved == {"encoder_xy_l0", "encoder_xy_l1", "encoder_xy_l2",
                     "encoder_xy_l3", "encoder_yz_l0", "encoder_yz_l1",
                     "encoder_yz_l2", "encoder_yz_l3", "encoder_xz_l0",
                     "encoder_xz_l1", "encoder_xz_l2", "encoder_xz_l3",
                     "unc_net", "aud_ch_att_net", "eye_att_net"}, moved


def _t(a):
    return torch.from_numpy(np.array(a))


def test_step_adds_the_regulariser_at_its_weight(world, monkeypatch):
    """The step's use of the regulariser, which the parity above cannot see
    at a weight of 1e-5: at step 32 it is called on the render's samples
    and mask with delta = (reg_delta * 2 - 1) * 1e-3 and adds
    step_factor * 1e-5 times its value to the loss (shifted here by 1e3 so
    that the term shows in float32); at step 33 it is not called."""
    from lzzx_nerf_tpu_torch.train import trainer

    w = world
    calls = []

    def shifted(shift):
        def fake(field, pts, dirs, mask, *a, **kw):
            calls.append((pts.detach().clone(), mask.clone(), a[3].clone()))
            return jitter_regulariser(field, pts, dirs, mask, *a, **kw) \
                + shift
        return fake

    d = _tdraws(_jax_draws(jax.random.PRNGKey(9), 32, N_RAYS * S))
    loss = {}
    for shift in (0.0, 1e3):
        monkeypatch.setattr(trainer, "jitter_regulariser", shifted(shift))
        tf, st, fn = _port(w, 32)
        loss[shift] = float(fn(st, w["tocc"], _tbatch(w["batch"]),
                               draws=d)["loss"])
    step_factor = 32 / ITERS
    np.testing.assert_allclose(loss[1e3] - loss[0.0],
                               step_factor * 1e-5 * 1e3, rtol=1e-3)
    assert len(calls) == 2
    pts, mask, delta = calls[0]
    np.testing.assert_allclose(delta.numpy(),
                               (d["reg_delta"].numpy() * 2 - 1) * 1e-3,
                               rtol=1e-6, atol=1e-12)
    assert pts.shape == (N_RAYS * S, 3) and mask.any() and not mask.all()
    tf, st, fn = _port(w, 33)
    fn(st, w["tocc"], _tbatch(w["batch"]), draws=d)
    assert len(calls) == 2


def _null_apply(params, pts, dirs, enc_a, c, eye, compute_uncertainty=True):
    z = jnp.zeros(pts.shape[0])
    return JOut(z, jnp.zeros_like(pts), z, z, z)


def _null_fn(pts, dirs):
    z = torch.zeros(pts.shape[0])
    return FieldOutputs(z, torch.zeros_like(pts), z, z, z)


@pytest.mark.parametrize("budget", [0, N_RAYS, 256])
def test_train_render_samples_match_jax(world, budget):
    """The step's sample set: the full march's mask, and the compacted
    render's mask, ray_weight and n_active (256 overflows) — equal. The
    field does not change them, so both sides render a null field."""
    w = world
    ds = w["ds"]
    d = _jax_draws(jax.random.PRNGKey(5), 0, 1)
    pose = w["batch"]["pose"]
    from lzzx_nerf_tpu.utils import get_rays as j_get_rays

    rays = j_get_rays(jnp.asarray(pose)[None], ds.intrinsics, RES, RES,
                      N=-1)
    ro = np.asarray(rays["rays_o"][0])[d["inds"]]
    rd = np.asarray(rays["rays_d"][0])[d["inds"]]
    bg = np.ones((N_RAYS, 3), np.float32)
    noise = np.array(d["noise"])
    args = [jnp.asarray(x) for x in (ro, rd)]
    if budget:
        jr = jax.jit(lambda o, r, b, n: j_render_compact(
            _null_apply, None, w["jrs"], w["jocc"], o, r, None, None, None,
            b, budget=budget, noise=n))(*args, jnp.asarray(bg),
                                        jnp.asarray(d["noise"]))
        tr = render_rays_train_compact(
            _null_fn, w["trs"], w["tocc"], torch.from_numpy(ro),
            torch.from_numpy(rd), torch.from_numpy(bg), budget,
            noise=torch.from_numpy(noise))
        assert int(tr["n_active"]) == int(jr["n_active"])
        np.testing.assert_array_equal(tr["ray_weight"].numpy(),
                                      np.asarray(jr["ray_weight"]))
        if budget < N_RAYS:
            assert int(tr["n_active"]) > budget
    else:
        jr = jax.jit(lambda o, r, b, n: j_render(
            _null_apply, None, w["jrs"], w["jocc"], o, r, None, None, None,
            b, noise=n, training=True))(*args, jnp.asarray(bg),
                                        jnp.asarray(d["noise"]))
        tr = render_rays(_null_fn, w["trs"], w["tocc"], torch.from_numpy(ro),
                         torch.from_numpy(rd), torch.from_numpy(bg),
                         noise=torch.from_numpy(noise), training=True)
    jmask = np.asarray(jr["rays"][2])
    np.testing.assert_array_equal(tr["rays"][2].numpy(), jmask)
    assert jmask.any() and not jmask.all()
    np.testing.assert_allclose(tr["rays"][0].numpy(),
                               np.asarray(jr["rays"][0]), atol=1e-6)


def test_compact_step_overflow_stays_finite(world):
    """A budget below the demand: finite loss and parameters, n_active
    above the budget (every aabb-hitting ray is active when the whole
    grid is occupied)."""
    w = world
    occ = w["tocc"]._replace(occ=torch.ones_like(w["tocc"].occ))
    tf, st, fn = _port(w, 0, train_budget=128, num_rays=512)
    m = fn(st, occ, _tbatch(w["batch"]), torch.Generator().manual_seed(4))
    assert int(m["n_active"]) > 128
    assert int(m["n_active_over"]) == int(m["n_active"]) - 128
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p).all() for p in tf.parameters())


def test_ema_on_its_interval_step(world):
    """The EMA moves by decay 0.95 only on steps whose new count is a
    multiple of ema_interval."""
    w = world
    tf, st, fn = _port(w, 0, ema_interval=2)
    e0 = {n: e.clone() for n, e in st.ema.items()}
    gen = torch.Generator().manual_seed(6)
    fn(st, w["tocc"], _tbatch(w["batch"]), gen)
    for n, e in st.ema.items():
        assert torch.equal(e, e0[n]), n
    fn(st, w["tocc"], _tbatch(w["batch"]), gen)
    for n, p in tf.named_parameters():
        want = 0.95 * e0[n] + (1 - 0.95) * p.detach()
        assert torch.equal(st.ema[n], want), n
        assert not torch.equal(st.ema[n], e0[n]) or n == "individual_codes"


def test_eval_step_with_ema_weights(world):
    """make_eval_step(use_ema=True) renders with the EMA weights and puts
    the live ones back."""
    w = world
    ds = w["ds"]
    tf, st, fn = _port(w, 0)
    fn(st, w["tocc"], _tbatch(w["batch"]), torch.Generator().manual_seed(7))
    live = {n: p.detach().clone() for n, p in tf.named_parameters()}
    kw = dict(H=RES, W=RES, intrinsics=ds.intrinsics)
    ev_ema = make_eval_step(tf, w["trs"], use_ema=True, **kw)
    ev = make_eval_step(tf, w["trs"], **kw)
    b = _tbatch(w["batch"])
    with_ema = ev_ema(st, w["tocc"], b)["image"]
    for n, p in tf.named_parameters():
        assert torch.equal(p.detach(), live[n]), n
    assert not torch.equal(with_ema, ev(st, w["tocc"], b)["image"])
    tf.load_state_dict(st.ema)
    assert torch.equal(with_ema, ev(st, w["tocc"], b)["image"])
