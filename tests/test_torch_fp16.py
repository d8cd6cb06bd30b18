"""bfloat16 compute under --fp16: the port's MLP, AudioNet, AudioAttNet
and NeRFField built with dtype=torch.bfloat16 against the flax modules
built with dtype=jnp.bfloat16 (param_dtype float32) on the same
parameters, and one head training step of a bfloat16 field against JAX's
on the same draws, at tests/test_train.py's 48² / grid 32 world
(tests/test_torch_train_step.py's fixture). The CLI builds its head field
in bfloat16 under cfg.fp16 (the default) and in float32 without it.

Tolerance of an output (the same for every one): at least 99 % of its
elements within rtol 1e-6 of JAX's (equal, up to XLA's and PyTorch's
float32 exp / softplus / sigmoid, which differ by an ulp), and every
element within 2^-8 (one bfloat16 ulp at the top binade) of the tensor's
largest magnitude. XLA and PyTorch sum a bfloat16 matmul's products in
other orders, and a few sums round to the neighbouring bfloat16 value;
where a layer's output cancels, that neighbour is several ulps of the
element (observed: 99.97 % of the MLP's outputs equal, the rest within 4
ulps). The step: the loss within rtol 2e-5, and every parameter's
gradient within 3e-2 of JAX's in relative L2 norm (the audio nets'
gradients are sums of bfloat16 products rounded in other orders;
observed up to 1.7e-2, on audio_net's conv biases).
A float32 port falls outside these tolerances: fewer than 1 % of its
outputs equal JAX's bfloat16 ones, and its audio nets' gradients differ
by 0.15-0.38 in relative L2 norm."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models.audio import AudioAttNet as JAudioAttNet
from lzzx_nerf_tpu.models.audio import AudioNet as JAudioNet
from lzzx_nerf_tpu.models.mlp import MLP as JMLP
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.data.synthetic import SyntheticTalkingHead
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.models.audio import AudioAttNet, AudioNet
from lzzx_nerf_tpu_torch.models.mlp import MLP
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                       make_train_step)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (ITERS, LOSS_RTOL, N_RAYS, S, _jax_draws,
                                   _tbatch, _tdraws, world)  # noqa: F401

MATCH_RTOL, MATCH_MIN, SPREAD = 1e-6, 0.99, 2.0 ** -8
GRAD_L2 = 3e-2
BF16, F32 = torch.bfloat16, torch.float32


def _held(got, want) -> bool:
    """got within the module docstring's tolerance of want."""
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    if got.shape != want.shape:
        return False
    d = np.abs(got - want)
    return bool(np.mean(d <= MATCH_RTOL * np.abs(want)) >= MATCH_MIN
                and np.all(d <= SPREAD * np.abs(want).max()))


def _load(module, flax_params):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        flax_params)))
    return module


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mlp_matches_flax_bf16():
    x = _x(512, 36)
    jm = JMLP(65, 64, 3, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), x)
    want = jm.apply(p, x)
    assert want.dtype == jnp.bfloat16
    out = {}
    for dt in (BF16, F32):
        m = _load(MLP(36, 65, 64, 3, dtype=dt), p)
        xt = torch.from_numpy(x).requires_grad_()
        out[dt] = m(xt)
        out[dt].float().sum().backward()
        # parameters and their gradients stay float32
        assert all(q.dtype == F32 and q.grad.dtype == F32
                   for q in m.parameters())
    assert out[BF16].dtype == BF16
    assert _held(out[BF16].detach(), want)
    assert not _held(out[F32].detach(), want)


def test_audio_nets_match_flax_bf16():
    auds = _x(8, 16, 29, seed=1)
    jnet = JAudioNet(dim_aud=32, dtype=jnp.bfloat16)
    pn = jnet.init(jax.random.PRNGKey(1), auds)
    want_n = jnet.apply(pn, auds)
    jatt = JAudioAttNet(dim_aud=32, dtype=jnp.bfloat16)
    pa = jatt.init(jax.random.PRNGKey(2), want_n[None])
    want_a = jatt.apply(pa, want_n[None])
    assert want_a.dtype == jnp.bfloat16
    for dt, ok in ((BF16, True), (F32, False)):
        net = _load(AudioNet(29, 32, dtype=dt), pn)
        att = _load(AudioAttNet(32, dtype=dt), pa)
        with torch.no_grad():
            enc = net(torch.from_numpy(auds))
            assert _held(enc, want_n) == ok
            # the attention on JAX's codes, so each net is held alone
            codes = torch.from_numpy(np.asarray(want_n, np.float32)).to(dt)
            assert _held(att(codes[None]), want_a) == ok
        assert enc.dtype == dt


@pytest.fixture(scope="module")
def field_case():
    rng = np.random.default_rng(0)
    auds = _x(8, 16, 29, seed=2)
    jf = JField(audio_in_dim=29, att=2, exp_eye=True, ind_dim=4, ind_num=64,
                dtype=jnp.bfloat16)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                     jnp.ones((4, 3)) / 3 ** 0.5, jnp.asarray(auds),
                     jnp.zeros(4), jnp.asarray([0.25]), method="init_all")
    # tables in ±0.5 (the ±1e-4 init gives encodings of float noise)
    inner = dict(params["params"])
    for k in sorted(inner):
        if k.startswith("encoder_"):
            inner[k] = jnp.asarray(rng.uniform(-0.5, 0.5, inner[k].shape)
                                   .astype(np.float32))
    params = {**params, "params": inner}
    N = 2048
    x = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = (rng.normal(size=4) * 0.1).astype(np.float32)
    e = np.asarray([0.3], np.float32)
    enc = jf.apply(params, jnp.asarray(auds), method="encode_audio")
    return dict(jf=jf, params=params, auds=auds, x=x, d=d, c=c, e=e,
                enc=enc, dens=jf.apply(params, x, enc, e, method="density"),
                out=jf.apply(params, x, d, enc, c, e))


DENSITY = ("sigma", "geo_feat", "ambient_aud", "ambient_eye")
FORWARD = ("sigma", "color", "ambient_aud", "ambient_eye", "uncertainty")


def test_field_density_and_forward_match_flax_bf16(field_case):
    w = field_case
    t = {k: torch.from_numpy(w[k]) for k in ("auds", "x", "d", "c", "e")}
    held = {}
    for dt in (BF16, F32):
        tf = _load(NeRFField(audio_in_dim=29, ind_num=64, dtype=dt),
                   w["params"])
        with torch.no_grad():
            enc = tf.encode_audio(t["auds"])
            # density and forward on JAX's audio code, so the field is
            # held apart from the audio nets
            jenc = torch.from_numpy(np.asarray(w["enc"], np.float32)).to(dt)
            dens = tf.density(t["x"], jenc, t["e"])
            out = tf(t["x"], t["d"], jenc, t["c"], t["e"])
        checks = {"enc_a": _held(enc, w["enc"])}
        for k in DENSITY:
            checks[f"density.{k}"] = _held(getattr(dens, k),
                                           getattr(w["dens"], k))
        for k in FORWARD:
            checks[f"forward.{k}"] = _held(getattr(out, k),
                                           getattr(w["out"], k))
        held[dt] = checks
        if dt == BF16:
            # JAX's promotions: float32 sigma, colour and uncertainty,
            # bfloat16 geometry features and ambient attentions
            assert dens.sigma.dtype == out.color.dtype == F32
            assert out.uncertainty.dtype == F32
            assert dens.geo_feat.dtype == dens.ambient_aud.dtype == BF16
            assert dens.ambient_eye.dtype == enc.dtype == BF16
    assert all(held[BF16].values()), held[BF16]
    assert not all(held[F32].values()), held[F32]
    assert not held[F32]["enc_a"] and not held[F32]["density.ambient_aud"]


def test_head_step_matches_jax_bf16(world):  # noqa: F811
    """One head training step at step 32 (every loss term weighed, the
    jitter regulariser on) of a bfloat16 field, on JAX's draws."""
    w = world
    step = 32
    jf = JField(audio_in_dim=w["ds"].audio_dim, att=2, exp_eye=True,
                ind_dim=4, ind_num=64, dtype=jnp.bfloat16)
    fn = jax.jit(j_make_step(jf, w["jrs"], w["tx"], **w["common"]))
    rng = jax.random.PRNGKey(3)
    state = JState.create(w["params"], w["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = fn(state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    draws = _tdraws(_jax_draws(rng, step, N_RAYS * S))

    worst = {}
    for dt in (BF16, F32):
        tf = _load(NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64,
                             dtype=dt), w["params"])
        st = TrainState.create(tf, HeadOptimizer(tf.named_parameters(),
                                                 1e-2, 1e-3, ITERS))
        st.step = step
        m = make_train_step(tf, w["trs"], **w["common"])(
            st, w["tocc"], _tbatch(w["batch"]), draws=draws)
        if dt == BF16:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=LOSS_RTOL)
        errs = {}
        for name, p in tf.named_parameters():
            assert p.dtype == p.grad.dtype == F32, name
            ref = jgrads[name].numpy()
            errs[name] = float(np.linalg.norm(p.grad.numpy() - ref)
                               / max(np.linalg.norm(ref), 1e-30))
        worst[dt] = max(errs.items(), key=lambda kv: kv[1])
        if dt == BF16:
            bad = {k: v for k, v in errs.items() if v > GRAD_L2}
            assert not bad, bad
    assert worst[F32][1] > GRAD_L2, worst


def test_cli_builds_the_head_in_bf16_under_fp16():
    """The CLI's head field computes in bfloat16 under --fp16 (the
    Config's default, and -O) and in float32 with --fp16 0; the torso
    stays float32 (parameters and compute)."""
    syn = SyntheticTalkingHead(num_frames=2, H=32, W=32)
    ds = types.SimpleNamespace(poses=np.stack([syn.pose(i) for i in (0, 1)]),
                               intrinsics=syn.intrinsics)
    for fp16, dt in ((True, BF16), (False, F32)):
        cfg = Config(path="unused", fp16=fp16, grid_size=32,
                     asr_model="deepspeech")
        _, _, field = cli._build_world(cfg, ds, torch.device("cpu"))
        assert field.dtype == dt
        assert field.sigma_net.dtype == field.audio_net.dtype == dt
        assert field.audio_att_net.dtype == dt
        assert all(p.dtype == F32 for p in field.parameters())
    assert cli.build_config(["data/x", "-O"]).fp16
    torso = cli._make_torso(Config(), torch.device("cpu"))
    assert all(p.dtype == F32 for p in torso.parameters())
    assert all(getattr(m, "dtype", F32) == F32 for m in torso.modules())
