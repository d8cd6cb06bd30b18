"""Parity of the port's models and weight loading with the JAX package, on
the CPU: the trained state loaded without JAX and carried across by
params_from_jax (bit-equal), the audio networks and the torso on the
trained weights, and the folded field (the plain version of the CUDA field
kernel) against the Pallas field kernel in interpret mode and against
NeRFField.apply.

Tolerances: weights are bit-equal; float outputs agree to 2e-5 relative
(1e-6 absolute) — float32 in both, differing only in summation order."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models import TorsoField as JTorso
from lzzx_nerf_tpu.ops import fused_field as jff
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.models import TorsoField as TTorso
from lzzx_nerf_tpu_torch.ops import fused_field as tff
from lzzx_nerf_tpu_torch.ops.sh import sh_encode
from lzzx_nerf_tpu_torch.serving.state_io import (TORSO_LEAF_PATHS,
                                                  load_trained_state,
                                                  params_from_jax)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

STATE = os.path.join(os.path.dirname(__file__), "..", "trained",
                     "production_state.pkl")
RTOL, ATOL = 2e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def trained():
    """(JAX-side pickle load, port load) of the shipped trained state."""
    with open(STATE, "rb") as f:
        jst = pickle.load(f)
    return jst, load_trained_state(STATE)


@pytest.fixture(scope="module")
def random_field():
    """JAX NeRFField params from init (the test_fused_field.py setup) and
    the port's field loaded from them."""
    field = JField(bound=1.0, encoder="dense")
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                        jnp.ones((4, 3)) / np.sqrt(3.0),
                        jnp.zeros((8, 2, 1024)), jnp.zeros((4,)),
                        jnp.zeros((1,)), method="init_all")
    # scale the triplane levels up so the features are not ~1e-4 noise
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(np.asarray, params)
    for name in list(p["params"]):
        if name.startswith("encoder_"):
            p["params"][name] = rng.uniform(
                -0.5, 0.5, p["params"][name].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, p)
    tfield = TField(audio_in_dim=1024, ind_num=10_000)
    tfield.load_state_dict(params_from_jax(p))
    return field, params, tfield


def test_trained_state_weights_bit_equal(trained):
    """Every leaf of the trained state after params_from_jax equals the
    JAX load bit for bit (kernels transposed back to the flax layout)."""
    jst, st = trained
    jhead = dict(_flat(jst["head_ema"]))
    thead = params_from_jax(st["head"])
    jtorso = jax.tree_util.tree_unflatten(jst["torso_treedef"],
                                          jst["torso_leaves"])
    jtorso = dict(_flat(jtorso["params"]))
    ttorso = params_from_jax(st["torso"])
    assert sorted(jtorso) == sorted(TORSO_LEAF_PATHS)
    for jflat, tsd in ((jhead, thead), (jtorso, ttorso)):
        assert len(jflat) == len(tsd)
        for path, ja in jflat.items():
            *mods, leaf = path.split("/")
            key = ".".join(mods + ["weight" if leaf == "kernel" else leaf])
            ta = tsd[key].numpy()
            if leaf == "kernel":
                ta = ta.T if ta.ndim == 2 else ta.transpose(2, 1, 0)
            assert ta.dtype == ja.dtype and ta.shape == ja.shape, path
            np.testing.assert_array_equal(ta.view(np.uint32),
                                          ja.view(np.uint32), err_msg=path)
    for k, v in jst["occ"].items():
        np.testing.assert_array_equal(st["occ"][k], np.asarray(v))
    for k in ("res", "grid", "audio_dim", "aabb", "dt", "intrinsics"):
        assert st["meta"][k] == jst["meta"][k]
    np.testing.assert_array_equal(st["meta"]["poses"], jst["meta"]["poses"])


def test_trained_audio_nets(trained):
    """AudioNet + AudioAttNet (encode_audio) on the trained weights."""
    jst, st = trained
    meta = st["meta"]
    jf = JField(audio_in_dim=int(meta["audio_dim"]), ind_num=64)
    tf = TField(audio_in_dim=int(meta["audio_dim"]), ind_num=64)
    tf.load_state_dict(params_from_jax(st["head"]))
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.standard_normal((8, 16, meta["audio_dim"])).astype(
            np.float32)
        j = jf.apply({"params": jst["head_ema"]}, jnp.asarray(a),
                     method="encode_audio")
        # the conv pyramid sums ~100 float32 terms of magnitude ~10 into
        # outputs of magnitude ~40: absolute tolerance 1e-4
        _close(tf.encode_audio(_t(a)), j, atol=1e-4)
        jn = jf.apply({"params": jst["head_ema"]}, jnp.asarray(a),
                      method=lambda m, x: m.audio_net(x))
        _close(tf.audio_net(_t(a)), jn, atol=1e-4)


def test_trained_torso(trained):
    """TorsoField on the trained weights and the baked f32 table."""
    jst, st = trained
    jtp = jax.tree_util.tree_unflatten(jst["torso_treedef"],
                                       [jnp.asarray(x)
                                        for x in jst["torso_leaves"]])
    jt = JTorso(ind_dim_torso=8, ind_num=64)
    tt = TTorso(ind_dim_torso=8, ind_num=64)
    tt.load_state_dict(params_from_jax(st["torso"]))
    jpk = jt.apply(jtp, method="bake_table")
    tpk = tt.bake_table()
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    pose = np.asarray(st["meta"]["poses"][3], np.float32)
    code = np.asarray(st["torso"]["individual_codes_torso"][0])
    ja, jc, jd = jt.apply(jtp, jnp.asarray(x), jnp.asarray(pose),
                          jnp.asarray(code), packed=jpk)
    ta, tc, td = tt(_t(x), _t(pose), _t(code), tpk)
    _close(ta, ja, atol=1e-5)
    _close(tc, jc, atol=1e-5)
    _close(td, jd, atol=1e-5)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    enc_a = (rng.standard_normal((1, 32)) * 0.3).astype(np.float32)
    ind = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    eye = np.asarray([0.25], np.float32)
    return pts, d, enc_a, ind, eye


@pytest.mark.parametrize("case", ["ind_eye", "no_ind_no_eye"])
def test_folded_field_matches_flax(random_field, case):
    """The port's folded field (plain version of the field kernel, f32 and
    bf16 tables) matches NeRFField.apply on the same points."""
    field, params, tfield = random_field
    pts, d, enc_a, ind, eye = _inputs(257, 1)
    if case == "no_ind_no_eye":
        out = field.apply(params, jnp.asarray(pts), jnp.asarray(d),
                          jnp.asarray(enc_a), jnp.zeros((4,)),
                          jnp.zeros((1,)), compute_uncertainty=False)
        ind_t = eye_t = None
    else:
        out = field.apply(params, jnp.asarray(pts), jnp.asarray(d),
                          jnp.asarray(enc_a), jnp.asarray(ind),
                          jnp.asarray(eye), compute_uncertainty=False)
        ind_t, eye_t = _t(ind), _t(eye)
    from lzzx_nerf_tpu_torch.models import make_fused_apply

    packed = tfield.bake_tables(torch.float32)
    apply = make_fused_apply(tfield, packed, _t(enc_a), ind_t, eye_t)
    sigma, color = apply(_t(pts), _t(d))
    _close(sigma, out.sigma)
    _close(color, out.color)


def test_folded_field_matches_pallas_kernel(random_field):
    """fused_field_reference (what the CUDA kernel is held to on the card)
    matches the Pallas field kernel run in interpret mode, including its
    tile-padding path, on the same enc_x / SH inputs."""
    field, params, tfield = random_field
    pts, d, enc_a, ind, eye = _inputs(300, 2)
    jw = jff.fold_frame_weights(jff.extract_field_weights(params),
                                jnp.asarray(enc_a), jnp.asarray(ind),
                                jnp.asarray(eye))
    enc_x = np.asarray(field.apply(params, jnp.asarray(pts),
                                   method="encode_x"))
    js, jc = jff.fused_field_eval(jw, jnp.asarray(enc_x), jnp.asarray(d),
                                  tile=128)
    tw = tff.fold_frame_weights(tff.extract_field_weights(tfield),
                                _t(enc_a), _t(ind), _t(eye))
    for name in tw._fields:
        # bias_c is a 4-term product: equal up to summation order
        np.testing.assert_allclose(getattr(tw, name).numpy(),
                                   np.asarray(getattr(jw, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    out = tff.fused_field_reference(tw, _t(enc_x), sh_encode(_t(d), 4))
    _close(out[:, 0], js)
    _close(out[:, 1:], jc)
    # the kernel's weight vector holds exactly the folded weights, split
    # into TF32 hi and lo parts
    wp = tff.pack_frame_weights(tw)
    hi, lo = tff.unpack_frame_weights(wp, "sig2")
    want = np.array(jw.sig2)[:, 1:]             # geo columns
    want_hi, want_lo = tff.tf32_split(torch.from_numpy(want))
    np.testing.assert_array_equal(hi.numpy(), want_hi.numpy())
    np.testing.assert_array_equal(lo.numpy(), want_lo.numpy())
    np.testing.assert_allclose((hi + lo).numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(                # sigma column, float32
        tff.unpack_frame_weights(wp, "sigma").numpy(),
        np.asarray(jw.sig2)[:, 0])
    assert wp.numel() * 4 <= 227 * 1024


def test_field_wrapper_device_contract(random_field):
    """On a CPU tensor the wrapper runs the plain version; the CUDA entry
    point refuses CPU tensors instead of falling back."""
    _, _, tfield = random_field
    pts, d, enc_a, ind, eye = _inputs(16, 3)
    tw = tff.fold_frame_weights(tff.extract_field_weights(tfield),
                                _t(enc_a), _t(ind), _t(eye))
    tables = tfield.bake_tables(torch.bfloat16)
    sigma, color = tff.fused_field_eval(tw, _t(pts), _t(d), tables,
                                        tfield.dense_spec, tfield.bound)
    assert sigma.shape == (16,) and color.shape == (16, 3)
    with pytest.raises(ValueError):
        tff.fused_field_cuda(_t(pts), _t(d), tables["xy"], tables["yz"],
                             tables["xz"], tfield.bound,
                             tff.pack_frame_weights(tw))
