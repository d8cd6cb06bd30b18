"""The hash head and the tiled torso in the port against the JAX package on
the CPU: the NeRFField(encoder="hash") forward and density (float32 and
bfloat16 compute), the TorsoField(encoder="tiled") forward and gradients,
the optimizer groups of their parameters, a full-path and a compacted head
step, a torso step, the head grid refresh, the serving field of one frame
(make_fused_apply) against JAX's, and an InferenceSession serving an
imported hash identity with its tiled torso against JAX's session.

Worlds: tests/test_train.py's 48², grid 32, 1,024 rays, S 8 (the steps,
from the JAX fields' own initial parameters, on JAX's draws), and the 64²
two-blob serving fixture of tests/test_torch_serving.py, imported from
one reference-layout .pth (tests/test_torch_convert.py's, numpy seed)
by each package's import tool.

Tolerances:
- forward, density, serving field: float32 rtol 2e-5, atol 1e-6 (tighter
  than tests/test_convert.py's 2e-4 / 2e-5: both packages run the same
  float32 operations, summed in other orders); bfloat16:
  tests/test_torch_fp16.py's rule (99 % of elements within 1e-6 relative,
  all within 2^-8 of the largest);
- the torso forward: tests/test_torch_train_torso.py's (alpha and colour
  2e-6 absolute, dx 1e-6 relative + 1e-7 absolute); its gradients to the
  step rule below, not to that file's field rule (1e-4 relative + 1e-5
  of the largest): the tiled grid's finest level has 2,048 cells (the
  dense torso's 512), so the ulp by which the two libraries round x + dx
  moves a point's interpolation fractions by 2,048 x 0.8 ulps, which
  reaches every parameter's gradient through the features and the
  grid's input gradient (observed: entries of the anchors, the codes and
  torso_net's first layer outside the field rule by up to 2e-4
  relative);
- the steps: tests/test_torch_train_step.py's and
  tests/test_torch_train_torso.py's (loss rtol 2e-5; gradients 1e-3
  relative + 1e-5 of the largest for all but 2 % of entries, relative L2
  1e-2; updated parameters rtol 5e-4 / atol 5e-5 except the head's
  tables);
- the refresh: the grid (densities: the field's sigma) to the forward's
  tolerance, the occupancy equal;
- the session: rgb24 and yuv420p bytes within one level, the per-chunk
  counters and the frame's march mask (its sample set) equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.models import TorsoField as JTorso
from lzzx_nerf_tpu.models.nerf import make_fused_apply as j_fused_apply
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render.grid_update import \
    make_density_grid_update as j_refresh_maker
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu.serving.streaming import NullSink as JNullSink
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.train.optim import param_label_fn as j_label
from lzzx_nerf_tpu.train.trainer import \
    make_torso_train_step as j_make_torso_step
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.models import NeRFField, TorsoField
from lzzx_nerf_tpu_torch.models.nerf import make_fused_apply
from lzzx_nerf_tpu_torch.render import (OccupancyState, RenderSettings,
                                        make_density_grid_update)
from lzzx_nerf_tpu_torch.serving import InferenceSession
from lzzx_nerf_tpu_torch.serving.session import COUNTERS
from lzzx_nerf_tpu_torch.serving.streaming import NullSink
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from lzzx_nerf_tpu_torch.tools import import_reference_ckpt as timport
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                       make_torso_train_step,
                                       make_train_step, param_label_fn)
from test_torch_bucket import jax_march_masks
from test_torch_convert import (reference_state, reference_torso,
                                write_reference_pth)
from test_torch_fp16 import _held
from test_torch_serving import (BASE, _JYuvSink, _YuvSink, _feats,
                                _quiet, _record_jax, _record_port)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (LOSS_RTOL, N_RAYS, PARAM_ATOL,
                                   PARAM_RTOL, S, _assert_grad_close,
                                   _capture, _jax_draws, _tbatch, _tdraws)
from test_torch_train_torso import OUT_ATOL

RES = 48
GRID = 32
ITERS = 100
RTOL, ATOL = 2e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


def _scaled(params, prefix, seed, scale=0.5):
    """The params with the tables named prefix* drawn in ±scale (at the
    ±1e-4 init the encoding is lost in rounding)."""
    rng = np.random.default_rng(seed)
    inner = dict(params["params"])
    for k in sorted(inner):
        if k.startswith(prefix):
            inner[k] = rng.uniform(-scale, scale, np.shape(inner[k])).astype(
                np.float32)
    return {"params": inner}


@pytest.fixture(scope="module")
def hworld():
    ds = JData(num_frames=8, H=RES, W=RES, torso=True)
    kw = dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=S,
              dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    jrs, trs = JRS(**kw), RenderSettings(**kw)
    field = JField(audio_in_dim=ds.audio_dim, att=2, exp_eye=True,
                   ind_dim=4, ind_num=64, encoder="hash")
    b0 = ds.frame(0)
    params = jax.tree.map(np.asarray, field.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3)) / 3 ** 0.5,
        jnp.asarray(b0["auds"]), jnp.zeros(4), jnp.asarray([0.2]),
        method="init_all"))
    r = jnp.linspace(-1, 1, GRID)
    X, Y, Z = jnp.meshgrid(r, r, r, indexing="ij")
    jocc = j_init_occ(jrs)._replace(
        occ=(jnp.sqrt(X ** 2 + Y ** 2 + Z ** 2) < 0.45)[None])
    tocc = OccupancyState(**{k: _t(v) for k, v in jocc._asdict().items()})
    torso = JTorso(ind_dim_torso=8, ind_num=64, encoder="tiled")
    tparams = jax.tree.map(np.asarray, torso.init(
        jax.random.PRNGKey(1), jnp.zeros((4, 2)), jnp.eye(4), jnp.zeros(8)))
    return dict(ds=ds, jrs=jrs, trs=trs, field=field, params=params,
                jocc=jocc, tocc=tocc, torso=torso, tparams=tparams)


def _port_field(params, audio_dim, dtype=torch.float32):
    f = NeRFField(audio_in_dim=audio_dim, ind_num=64, encoder="hash",
                  dtype=dtype)
    f.load_state_dict(params_from_jax(params))
    return f


def _field_inputs(ds, n=700, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.02, 1.02, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d, ds.frame(2)["auds"], np.float32([0.3])


def test_hash_field_forward_and_density_match_jax(hworld):
    w = hworld
    params = _scaled(w["params"], "encoder_", 11)
    jp = jax.tree.map(jnp.asarray, params)
    x, d, auds, e = _field_inputs(w["ds"])
    jf = w["field"]
    j_enc = jf.apply(jp, jnp.asarray(auds), method="encode_audio")
    code = jp["params"]["individual_codes"][5]
    jout = jf.apply(jp, jnp.asarray(x), jnp.asarray(d), j_enc, code,
                    jnp.asarray(e))
    jdens = jf.apply(jp, jnp.asarray(x), j_enc, jnp.asarray(e),
                     method="density")
    jenc_x = jf.apply(jp, jnp.asarray(x), method="encode_x")
    tf = _port_field(params, w["ds"].audio_dim)
    with torch.no_grad():
        t_enc = tf.encode_audio(_t(auds))
        tout = tf(_t(x), _t(d), t_enc, tf.individual_codes[5], _t(e))
        tdens = tf.density(_t(x), t_enc, _t(e))
        tenc_x = tf.encode_x(_t(x))
    np.testing.assert_array_equal(tenc_x.numpy(), _n(jenc_x))
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert oob.any() and np.abs(_n(jenc_x)[~oob]).max() > 0.1
    for got, want in (*zip(tout, jout), *zip(tdens, jdens)):
        np.testing.assert_allclose(got.numpy(), _n(want), rtol=RTOL,
                                   atol=ATOL)
    with pytest.raises(ValueError, match="interp_dtype"):
        tf.encode_x(_t(x), interp_dtype=torch.bfloat16)
    assert tf.bake_tables() == {} and tf.bake_train_tables() == {}


def test_hash_field_matches_flax_bf16(hworld):
    """The CLI's --fp16 head (bfloat16 compute, float32 parameters) with
    the hash encoder."""
    w = hworld
    params = _scaled(w["params"], "encoder_", 12)
    jp = jax.tree.map(jnp.asarray, params)
    jf = JField(audio_in_dim=w["ds"].audio_dim, att=2, exp_eye=True,
                ind_dim=4, ind_num=64, encoder="hash", dtype=jnp.bfloat16)
    x, d, auds, e = _field_inputs(w["ds"], seed=4)
    j_enc = jf.apply(jp, jnp.asarray(auds), method="encode_audio")
    jout = jf.apply(jp, jnp.asarray(x), jnp.asarray(d), j_enc,
                    jp["params"]["individual_codes"][1], jnp.asarray(e))
    tf = _port_field(params, w["ds"].audio_dim, torch.bfloat16)
    with torch.no_grad():
        t_enc = tf.encode_audio(_t(auds))
        tout = tf(_t(x), _t(d), t_enc, tf.individual_codes[1], _t(e))
    assert _held(t_enc, j_enc)
    for name, got, want in zip(tout._fields, tout, jout):
        assert _held(got, want), name


def test_serving_field_matches_jax(hworld):
    """make_fused_apply of a hash head (grid_encode, then the enc_x
    entry's plain version on the CPU) against JAX's folded apply."""
    w = hworld
    params = _scaled(w["params"], "encoder_", 13)
    jp = jax.tree.map(jnp.asarray, params)
    x, d, auds, e = _field_inputs(w["ds"], seed=5)
    jf = w["field"]
    j_enc = jf.apply(jp, jnp.asarray(auds), method="encode_audio")
    code = jp["params"]["individual_codes"][0]
    jout = j_fused_apply(jf, {})(jp, jnp.asarray(x), jnp.asarray(d), j_enc,
                                 code, jnp.asarray(e))
    tf = _port_field(params, w["ds"].audio_dim)
    t_enc = tf.encode_audio(_t(auds))
    for use_kernel in (True, False):
        sig, col = make_fused_apply(tf, tf.bake_tables(torch.bfloat16),
                                    t_enc, tf.individual_codes[0].detach(),
                                    _t(e), use_kernel=use_kernel)(_t(x),
                                                                  _t(d))
        np.testing.assert_allclose(sig.numpy(), _n(jout.sigma), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(col.numpy(), _n(jout.color), rtol=RTOL,
                                   atol=ATOL)


def _port_torso(params):
    tt = TorsoField(ind_dim_torso=8, ind_num=64, encoder="tiled")
    tt.load_state_dict(params_from_jax(params))
    return tt


def test_tiled_torso_forward_and_gradients_match_jax(hworld):
    """alpha, colour and dx of the JAX tiled TorsoField against
    train_forward and the serving forward, and the gradient of a weighted
    sum of the three with respect to every parameter."""
    w = hworld
    params = _scaled(w["tparams"], "torso_encoder", 6)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.3, 1.3, (600, 2)).astype(np.float32)
    pose = w["ds"].pose(3)
    wa, wc, wd = (rng.normal(size=s).astype(np.float32)
                  for s in ((len(x), 1), (len(x), 3), (len(x), 2)))

    def jf(p):
        a, c, d = w["torso"].apply(p, jnp.asarray(x), jnp.asarray(pose),
                                   p["params"]["individual_codes_torso"][5])
        return jnp.sum(a * wa) + jnp.sum(c * wc) + jnp.sum(d * wd), (a, c, d)

    (_, (ja, jc, jd)), jg = jax.value_and_grad(jf, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tt = _port_torso(params)
    assert tt.bake_table() is None and tt.bake_train_table() is None
    ta, tc, td = tt.train_forward(_t(x), _t(pose),
                                  tt.individual_codes_torso[5])
    (torch.sum(ta * _t(wa)) + torch.sum(tc * _t(wc))
     + torch.sum(td * _t(wd))).backward()
    np.testing.assert_allclose(ta.detach().numpy(), _n(ja), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(tc.detach().numpy(), _n(jc), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(td.detach().numpy(), _n(jd), rtol=1e-6,
                               atol=1e-7)
    ref = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tt.named_parameters():
        _assert_grad_close(p.grad.numpy(), ref[name].numpy(), name)
    assert float(tt.torso_encoder.grad.abs().max()) > 0
    sa, sc, _ = tt(_t(x), _t(pose), tt.individual_codes_torso[5].detach())
    np.testing.assert_array_equal(sa.numpy(), ta.detach().numpy())
    np.testing.assert_array_equal(sc.numpy(), tc.detach().numpy())


def _labels(params):
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    out = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        out[".".join(keys[:-1] + (["weight"] if keys[-1] == "kernel"
                                  else keys[-1:]))] = j_label(path, leaf)
    return out


def test_param_groups_match_jax(hworld):
    w = hworld
    for module, params, grid in (
            (_port_field(w["params"], w["ds"].audio_dim), w["params"],
             ["encoder_xy", "encoder_xz", "encoder_yz"]),
            (_port_torso(w["tparams"]), w["tparams"], ["torso_encoder"])):
        got = {n: param_label_fn(n) for n, _ in module.named_parameters()}
        assert got == _labels(params)
        opt = HeadOptimizer(module.named_parameters(), 1e-2, 1e-3, 10)
        assert sorted(opt.groups["grid"]["names"]) == grid
        assert opt.groups["grid"]["wd"] == 0.01


@pytest.fixture(scope="module")
def steps(hworld):
    w = hworld
    tx = _capture(build_optimizer(lr=1e-2, lr_net=1e-3, iters=ITERS))
    common = dict(H=RES, W=RES, intrinsics=w["ds"].intrinsics,
                  num_rays=N_RAYS, iters=ITERS, ind_dim=4, ema_interval=50)
    return dict(tx=tx, common=common, fns={
        "full": jax.jit(j_make_step(w["field"], w["jrs"], tx, **common)),
        "compact": jax.jit(j_make_step(w["field"], w["jrs"], tx,
                                       train_budget=N_RAYS, **common)),
        "torso": jax.jit(j_make_torso_step(w["torso"], w["jrs"], tx, H=RES,
                                           W=RES, num_rays=N_RAYS,
                                           ind_dim_torso=8))})


@pytest.mark.parametrize("path", ["full", "compact"])
def test_hash_head_step_matches_jax(hworld, steps, path):
    """One head step at step 32 (the jitter regulariser fires) on JAX's
    draws: loss, every gradient, the updated parameters."""
    w, step = hworld, 32
    budget = N_RAYS if path == "compact" else 0
    rng = jax.random.PRNGKey(3)
    state = JState.create(jax.tree.map(jnp.asarray, w["params"]),
                          steps["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    batch = w["ds"].frame(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "bg_torso_color"}
    js, jm = steps["fns"][path](state, w["jocc"], jb, rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    draws = _jax_draws(rng, step, (budget or N_RAYS) * S)
    tf = _port_field(w["params"], w["ds"].audio_dim)
    st = TrainState.create(tf, HeadOptimizer(tf.named_parameters(), 1e-2,
                                             1e-3, ITERS))
    st.step = step
    fn = make_train_step(tf, w["trs"], train_budget=budget,
                         **steps["common"])
    m = fn(st, w["tocc"], _tbatch({k: v for k, v in batch.items()
                                   if k != "bg_torso_color"}),
           draws=_tdraws(draws))
    assert st.step == step + 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    if budget:
        assert int(m["n_active"]) == int(jm["n_active"]) > 0
    for name, p in tf.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        if not name.startswith("encoder_"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)
    assert float(tf.encoder_xy.grad.abs().max()) > 0


def test_tiled_torso_step_matches_jax(hworld, steps):
    """One torso step at step 999 (the EMA moves) on JAX's pixels."""
    w, step = hworld, 999
    params = _scaled(w["tparams"], "torso_encoder", 13)
    grid = np.zeros((GRID, GRID), np.float32)
    grid[GRID // 2:] = 0.5
    jocc = w["jocc"]._replace(density_grid_torso=jnp.asarray(grid),
                              mean_density_torso=jnp.asarray(0.25))
    tocc = OccupancyState(**{k: _t(v) for k, v in jocc._asdict().items()})
    rng = jax.random.PRNGKey(4)
    state = JState.create(jax.tree.map(jnp.asarray, params),
                          steps["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    b = dict(w["ds"].frame(3), bg_color=np.ones((RES, RES, 3), np.float32))
    js, jm = steps["fns"]["torso"](state, jocc,
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))
    jema = params_from_jax(jax.tree.map(np.asarray, js.ema_params))
    inds = np.asarray(jax.random.randint(jax.random.fold_in(rng, step),
                                         (N_RAYS,), 0, RES * RES))
    tt = _port_torso(params)
    st = TrainState.create(tt, HeadOptimizer(tt.named_parameters(), 1e-2,
                                             1e-3, ITERS))
    st.step = step
    fn = make_torso_train_step(tt, w["trs"], H=RES, W=RES, num_rays=N_RAYS,
                               ind_dim_torso=8)
    m = fn(st, tocc, _tbatch(b), draws={"inds": _t(inds)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for name, p in tt.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(st.ema[name].numpy(), jema[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
    assert float(tt.torso_encoder.grad.abs().max()) > 0


def test_hash_refresh_matches_jax(hworld):
    """One head grid refresh through the hash head on JAX's jitter."""
    w = hworld
    params = _scaled(w["params"], "encoder_", 14, scale=2.0)
    jp = jax.tree.map(jnp.asarray, params)
    b = w["ds"].frame(3)
    rng, step = jax.random.PRNGKey(11), 32
    jocc = j_init_occ(w["jrs"])
    jnew = j_refresh_maker(w["field"], w["jrs"])(
        jp, jocc, jnp.asarray(b["auds"]), jnp.asarray(b["eye"]), rng, step)
    k = jax.random.fold_in(jax.random.fold_in(rng, step), 0x6772)
    _, sub = jax.random.split(k)
    jitter = [_t(np.asarray(jax.random.uniform(sub, (GRID ** 3, 3))))]
    tf = _port_field(params, w["ds"].audio_dim)
    tnew = make_density_grid_update(tf, w["trs"])(
        OccupancyState(**{k: _t(v) for k, v in jocc._asdict().items()}),
        _t(b["auds"]), _t(b["eye"]), jitter=jitter)
    np.testing.assert_allclose(tnew.density_grid.numpy(),
                               _n(jnew.density_grid), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tnew.occ.numpy(), _n(jnew.occ))
    assert 0 < int(tnew.occ.sum()) < tnew.occ.numel()


# ---- serving an imported identity ---------------------------------------

@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    """One reference .pth (hash head with tables in ±0.5 scale, tiled
    torso, the two-blob occupancy as its Morton density grid, a torso grid
    over the lower half) imported by the JAX script and by the port's
    tool over the 64² two-blob dataset."""
    from conftest import make_toy_dataset

    from lzzx_nerf_tpu.data.synthetic import two_blob_occupancy

    root = tmp_path_factory.mktemp("hash_id")
    data = make_toy_dataset(root / "data", H=64, W=64, focal_mult=4.0)
    sd = reference_state(seed=21, table_scale=0.5)
    tsd = reference_torso(seed=22)
    tgrid = np.zeros((GRID, GRID), np.float32)
    tgrid[GRID // 2:] = 0.5
    tsd["density_grid_torso"] = tgrid.reshape(-1)
    natural = np.where(np.asarray(two_blob_occupancy(GRID)), 20.0,
                       0.0).astype(np.float32)
    pth, tpth = root / "head.pth", root / "torso.pth"
    write_reference_pth(pth, sd, natural, mean_density=2.0, global_step=5)
    write_reference_pth(tpth, tsd, mean_density_torso=0.25)
    args = ["--ckpt", str(pth), "--data", data, "--asr_model", "deepspeech",
            "--grid_size", str(GRID), "--torso-ckpt", str(tpth)]
    timport.main(args + ["--workspace", str(root / "tws"), "--device",
                         "cpu"], log=_quiet)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from import_reference_ckpt import main as j_import

    argv = sys.argv
    sys.argv = ["import_reference_ckpt"] + args + [
        "--workspace", str(root / "jws")]
    try:
        j_import()
    finally:
        sys.argv = argv
    return data, str(root / "jws"), str(root / "tws")


def test_imported_identity_serves_like_jax(identity):
    """rgb24 and yuv420p frames within one level, the per-chunk counters
    equal, the tiled torso composited; one frame's march mask equal to
    the JAX renderer's."""
    data, jws, tws = identity
    plan = dict(infer_window_candidates=40, budget_frac=1.0, infer_chunk=2)
    js = JSession(JConfig(**BASE, **plan))
    js.load_model(data, jws)
    ts = InferenceSession(Config(**BASE, **plan), device="cpu", log=_quiet)
    ts.load_model(data, tws)
    assert ts.cfg.encoder == "hash" and ts.field.encoder == "hash"
    assert ts.torso is not None and ts.torso.encoder == "tiled"
    assert js.torso is not None
    assert (ts.k2, ts.bucket, ts.budget, ts.stage2_budget) == (
        js.k2, js._bucket, js.budget, js.stage2_budget)
    assert ts.path == "blocks" and ts.march_group == 2
    feats = _feats(5, 3)
    frames = {}
    for fmt, jsink, tsink in (("rgb24", JNullSink, NullSink),
                              ("yuv420p", _JYuvSink, _YuvSink)):
        jrec, trec, jf, tf = [], [], [], frames.setdefault(fmt, [])
        _record_jax(js, jrec)
        _record_port(ts, trec)
        for s in (js, ts):
            s.set_audio_features(feats)
        js.run(jsink(), on_frame=lambda i, b: jf.append((i, np.asarray(b))))
        ts.run(tsink(), on_frame=lambda i, b: tf.append((i, b)))
        assert [i for i, _ in tf] == [i for i, _ in jf] == list(range(5))
        for (_, a), (_, b) in zip(tf, jf):
            assert a.shape == b.shape and a.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, fmt
        assert len(trec) == len(jrec) == 3
        for (base, cnt), (acts, wm, s2, rl, lg) in zip(trec, jrec):
            c = dict(zip(COUNTERS, cnt.T))
            assert list(c["n_active"]) == list(acts[:len(cnt)])
            assert (c["n_winmax"].max(), c["n_stage2"].max(),
                    c["n_real"].max(), c["n_long"].max()) == (wm, s2, rl, lg)
    # the frames are not the background alone: head and torso render
    img = frames["rgb24"][0][1].reshape(64, 64, 3).astype(int)
    assert np.abs(img - 200).max() > 20
    # one frame's sample set against the JAX renderer's
    auds = np.random.default_rng(9).standard_normal((8, 16, 29)).astype(
        np.float32)
    with torch.no_grad():
        out = ts.render_frame(0, ts.field.encode_audio(_t(auds)),
                              _t(np.float32([0.25])))
    rays = j_get_rays(jnp.asarray(ts.poses[0])[None], ts.intrinsics, 64, 64,
                      N=-1)
    jset = JRS(bound=1.0, cascade=1, grid_size=GRID,
               max_steps=ts.settings.max_steps,
               dt=ts.settings.dt, num_cand=ts.settings.num_cand,
               aabb=ts.settings.aabb)
    from lzzx_nerf_tpu.ops import march2 as jm2

    jtables = jm2.build_inference_tables(jnp.asarray(ts.occ.occ.numpy()),
                                         1.0, variants=("nb5w", "dil"))
    jmask = jax_march_masks(jset, jtables, rays["rays_o"][0][0],
                            rays["rays_d"][0], 64, 64, ts.budget, ts.k2,
                            ts.bucket, ts.eval_budget)
    assert jmask.sum() > 100
    np.testing.assert_array_equal(out["march_mask"].numpy(), jmask)
