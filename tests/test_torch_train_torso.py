"""The torso stage in the port against the JAX package on the CPU: the
trainable TorsoField, run_torso, torso_losses, the torso grid refresh, the
torso step and the torso optimizer groups, at 48², grid 32 (the world of
tests/test_train.py), from the JAX TorsoField's own initial parameters and
on JAX's draws.

Tolerances:
- torso forward: alpha and colour within 2e-6 absolute, dx within 1e-6
  relative + 1e-7 absolute (float32 MLPs summed in another order; the
  anchors go through inv(pose.T), which XLA and LAPACK round differently
  in the last ulp); every parameter gradient within 1e-4 relative + 1e-5
  of its largest entry (tests/test_torch_train_field.py's field rule),
  the tables' to the step rule below: a corner weight of the 512-cell
  level moves by 512 x the rounding of the point's x + dx, which the
  deform net rounds differently in the two libraries, and a weight near 0
  then has no relative bound (observed: 1-4 entries of 526,338 outside
  the field rule, at most 1.8e-5 of the largest);
- run_torso and torso_losses: outputs 2e-6 absolute, loss rtol 1e-6,
  gradients as the forward's;
- the refresh on JAX's jitter: the grid rtol 1e-6 (atol 1e-9 where the
  alpha of a cell is ~0), its mean rtol 1e-5 (a sum of 1,024 values in
  another order); with the same alpha values on both sides the grid —
  the 5x5 max-pool's border cells included — is equal;
- the step: loss rtol 2e-5, gradients to tests/test_torch_train_step.py's
  rule (1e-3 relative + 1e-5 of the largest, at most 2 % of entries
  exempt, relative L2 1e-2), updated parameters and EMA rtol 5e-4 / atol
  5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.data import SyntheticTalkingHead as JData
from lzzx_nerf_tpu.models import TorsoField as JTorso
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render import init_occupancy_state as j_init_occ
from lzzx_nerf_tpu.render.grid_update import \
    make_torso_grid_update as j_make_refresh
from lzzx_nerf_tpu.render.grid_update import \
    update_torso_grid as j_update_torso
from lzzx_nerf_tpu.render.renderer import run_torso as j_run_torso
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train.losses import torso_losses as j_torso_losses
from lzzx_nerf_tpu.train.optim import param_label_fn as j_label
from lzzx_nerf_tpu.train.trainer import \
    make_torso_train_step as j_make_torso_step
from lzzx_nerf_tpu.utils.rays import get_bg_coords as j_bg_coords
from lzzx_nerf_tpu_torch.models import TorsoField
from lzzx_nerf_tpu_torch.render import (OccupancyState, RenderSettings,
                                        make_torso_grid_update, run_torso,
                                        update_torso_grid)
from lzzx_nerf_tpu_torch.serving.state_io import params_from_jax
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                       make_torso_train_step, param_label_fn,
                                       torso_losses)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                   _assert_grad_close, _capture)

RES = 48
GRID = 32
N_RAYS = 1024
ITERS = 100
OUT_ATOL = 2e-6
FWD_GRAD_RTOL, FWD_GRAD_TAIL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def tworld():
    ds = JData(num_frames=8, H=RES, W=RES, torso=True)
    jt = JTorso(ind_dim_torso=8, ind_num=64)
    params = jax.tree.map(np.asarray, jt.init(
        jax.random.PRNGKey(1), jnp.zeros((4, 2)), jnp.eye(4),
        jnp.zeros(8)))
    kw = dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=8,
              dt=2 * 3 ** 0.5 / GRID, num_cand=28)
    jrs, trs = JRS(**kw), RenderSettings(**kw)
    # a torso grid with occupied and empty cells: the lower half (rows
    # index height) above the threshold
    grid = np.zeros((GRID, GRID), np.float32)
    grid[GRID // 2:] = 0.5
    jocc = j_init_occ(jrs)._replace(density_grid_torso=jnp.asarray(grid),
                                    mean_density_torso=jnp.asarray(0.25))
    tocc = OccupancyState(**{k: _t(v) for k, v in jocc._asdict().items()})
    return dict(ds=ds, jt=jt, params=params, jrs=jrs, trs=trs, jocc=jocc,
                tocc=tocc)


def _port_torso(params):
    tt = TorsoField(ind_dim_torso=8, ind_num=64)
    tt.load_state_dict(params_from_jax(params))
    return tt


def _scaled_tables(params, seed, zero_deform=False):
    """The params with tables drawn in ±0.5 (at the ±1e-4 init the lookup's
    contribution is lost in rounding) and, optionally, the deform net's
    last layer at 0 (dx = 0 exactly)."""
    rng = np.random.default_rng(seed)
    inner = {k: v for k, v in params["params"].items()}
    for k in sorted(inner):
        if k.startswith("torso_encoder_"):
            inner[k] = rng.uniform(-0.5, 0.5, inner[k].shape).astype(
                np.float32)
    if zero_deform:
        d = dict(inner["torso_deform_net"])
        d["net_2"] = {"kernel": np.zeros_like(d["net_2"]["kernel"])}
        inner["torso_deform_net"] = d
    return {"params": inner}


def _assert_fwd_grads(tt, jg):
    ref = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tt.named_parameters():
        r = ref[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
        if name.startswith("torso_encoder_"):
            _assert_grad_close(g, r, name)
            continue
        tol = FWD_GRAD_RTOL * np.abs(r) + FWD_GRAD_TAIL * np.abs(r).max()
        bad = np.abs(g - r) > tol
        assert not bad.any(), (name, int(bad.sum()), np.abs(g - r).max())


@pytest.mark.parametrize("case", ["init", "tables", "bound"])
def test_torso_forward_and_gradients_match_jax(tworld, case):
    """alpha, colour and dx of the JAX TorsoField.__call__ (in-graph bake)
    against train_forward, and the gradient of a weighted sum of the three
    with respect to every parameter. "bound": the deform net's last layer
    at 0, so dx = 0 and x * 0.8 lands on ±1 exactly at x = ±1.25 (jnp.clip
    passes half the gradient there, and the lookup's own clip of the
    [0, 1] coordinate another half); points past ±1.25 saturate."""
    w = tworld
    params = w["params"]
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (600, 2)).astype(np.float32)
    if case != "init":
        params = _scaled_tables(params, 6, zero_deform=case == "bound")
    if case == "bound":
        edge = np.float32([[1.25, 0.3], [-1.25, -0.2], [0.1, 1.25],
                           [0.4, -1.25], [1.25, 1.25], [-1.25, 1.25],
                           [1.3, 0.0], [-1.4, 0.5]])
        x = np.concatenate([x, np.repeat(edge, 8, axis=0)])
        assert (np.float32(1.25) * np.float32(0.8)) == np.float32(1.0)
    pose = w["ds"].pose(3)
    code = params["params"]["individual_codes_torso"][5]
    wa, wc, wd = (rng.normal(size=s).astype(np.float32)
                  for s in ((len(x), 1), (len(x), 3), (len(x), 2)))

    def jf(p):
        a, c, d = w["jt"].apply(p, jnp.asarray(x), jnp.asarray(pose),
                                p["params"]["individual_codes_torso"][5])
        return jnp.sum(a * wa) + jnp.sum(c * wc) + jnp.sum(d * wd), (a, c, d)

    (_, (ja, jc, jd)), jg = jax.value_and_grad(jf, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tt = _port_torso(params)
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
    assert float(np.abs(_n(code))[0]) > 0
    _assert_fwd_grads(tt, jg)
    if case == "bound":
        # the tie rule moves the deform net's last layer: all of its
        # gradient comes through the clip and the lookup at those points
        g = tt.torso_deform_net.net_2.weight.grad
        assert g is not None and g.abs().max() > 0


def test_serving_forward_equals_train_forward(tworld):
    """The serving forward (baked table, given inverse pose, no graph)
    gives what train_forward gives, bit for bit."""
    w = tworld
    tt = _port_torso(_scaled_tables(w["params"], 7))
    x = torch.rand((500, 2), generator=torch.Generator().manual_seed(2)) \
        * 2.6 - 1.3
    pose = _t(w["ds"].pose(1))
    inv_t = torch.linalg.inv(pose.T)
    code = tt.individual_codes_torso[2]
    serve = tt(x, pose, code, tt.bake_table(), inv_t)
    with torch.no_grad():
        train = tt.train_forward(x, pose, code)
    for a, b in zip(serve, train):
        assert torch.equal(a, b)


def test_torso_init_params_schemes(tworld):
    """init_params draws the JAX TorsoField's initialisers: tables within
    ±1e-4, kernels within ±1/sqrt(fan-in) (both reaching 0.9 of the bound
    where they have 256 entries or more), codes with spread 0.1, the
    anchors fixed; one seed gives one draw."""
    ref = params_from_jax(tworld["params"])
    a = TorsoField(ind_num=64).init_params(torch.Generator().manual_seed(4))
    b = TorsoField(ind_num=64).init_params(torch.Generator().manual_seed(4))
    for name, p in a.named_parameters():
        assert torch.equal(p, dict(b.named_parameters())[name]), name
        x, r = p.detach().numpy(), ref[name].numpy()
        assert x.shape == r.shape, name
        if name == "anchor_points":
            np.testing.assert_array_equal(x, r)
        elif name == "individual_codes_torso":
            assert abs(x.std() - 0.1) < 0.02 and abs(r.std() - 0.1) < 0.02
        else:
            bound = (1e-4 if name.startswith("torso_encoder_")
                     else 1 / np.sqrt(p.shape[1])) * (1 + 1e-6)
            for v in (x, r):
                assert np.abs(v).max() <= bound, name
                assert v.size < 256 or np.abs(v).max() > 0.9 * bound, name


def test_torso_param_groups_match_optax_labels(tworld):
    """The torso's optimizer groups: param_label_fn's label of every
    parameter equals optax's multi_transform label on the JAX torso tree
    (tables grid, everything else net), and HeadOptimizer groups them so."""
    flat = jax.tree_util.tree_flatten_with_path(tworld["params"]["params"])[0]
    want = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        name = ".".join(keys[:-1] + (["weight"] if keys[-1] == "kernel"
                                     else keys[-1:]))
        want[name] = j_label(path, leaf)
    tt = _port_torso(tworld["params"])
    got = {n: param_label_fn(n) for n, _ in tt.named_parameters()}
    assert got == want and set(got.values()) == {"grid", "net"}
    opt = HeadOptimizer(tt.named_parameters(), 1e-2, 1e-3, 10)
    assert sorted(opt.groups["grid"]["names"]) == [
        f"torso_encoder_l{i}" for i in range(4)]
    assert opt.groups["grid"]["lr"] == 1e-2 and opt.groups["grid"]["wd"] \
        == 0.01
    assert opt.groups["net"]["lr"] == 1e-3 and opt.groups["net"]["wd"] == 0


def test_run_torso_and_losses_match_jax(tworld):
    """run_torso (dense, masked by the torso grid, composited over the
    background; "torso_color" is the composite) and torso_losses against
    JAX's: outputs, loss and every parameter gradient, with the loss's
    gradients with respect to its inputs."""
    w = tworld
    params = _scaled_tables(w["params"], 8)
    rng = np.random.default_rng(9)
    inds = rng.integers(0, RES * RES, 700)
    coords = _n(j_bg_coords(RES, RES)[0])[inds]
    bg = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    pose = w["ds"].pose(2)

    def jl(p):
        out = j_run_torso(w["jt"].apply, p, w["jrs"], w["jocc"],
                          jnp.asarray(coords), jnp.asarray(pose),
                          p["params"]["individual_codes_torso"][2],
                          jnp.asarray(bg))
        return j_torso_losses(out["torso_color"], jnp.asarray(gt),
                              out["torso_alpha"],
                              p["params"]["anchor_points"]), out

    (jv, jout), jg = jax.value_and_grad(jl, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tt = _port_torso(params)
    out = run_torso(tt.train_forward, w["trs"], w["tocc"], _t(coords),
                    _t(pose), tt.individual_codes_torso[2], _t(bg))
    loss = torso_losses(out["torso_color"], _t(gt), out["torso_alpha"],
                        tt.anchor_points)
    loss.backward()
    masked = _n(jout["torso_alpha"])[:, 0] == 0
    assert 100 < masked.sum() < 600
    for k in ("bg_color", "torso_alpha", "torso_color", "deform"):
        np.testing.assert_allclose(out[k].detach().numpy(), _n(jout[k]),
                                   rtol=1e-6, atol=OUT_ATOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-6)
    _assert_fwd_grads(tt, jg)

    # the loss alone, off the anchors' init (there its anchor term is 0)
    pred, alpha = (rng.uniform(0, 1, s).astype(np.float32)
                   for s in ((700, 3), (700, 1)))
    anchor = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    jv, jgs = jax.value_and_grad(j_torso_losses, argnums=(0, 2, 3))(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(alpha),
        jnp.asarray(anchor))
    ts = [_t(a).requires_grad_(True) for a in (pred, alpha, anchor)]
    tv = torso_losses(ts[0], _t(gt), ts[1], ts[2])
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    for t, j in zip(ts, jgs):
        np.testing.assert_allclose(t.grad.numpy(), _n(j), rtol=1e-5,
                                   atol=1e-10)


def _jax_refresh_jitter(rng, step):
    k = jax.random.fold_in(jax.random.fold_in(rng, step), 0x746F)
    return np.asarray(jax.random.uniform(k, (GRID * GRID, 2)))


def test_torso_refresh_matches_jax(tworld):
    """make_torso_grid_update on JAX's jitter (the refresh folds its own
    domain tag): individual code 0, the EMA-max against an old grid, the
    plain mean."""
    w = tworld
    params = _scaled_tables(w["params"], 10)
    rng = np.random.default_rng(11)
    old = rng.uniform(0, 0.6, (GRID, GRID)).astype(np.float32)
    jocc = w["jocc"]._replace(density_grid_torso=jnp.asarray(old))
    tocc = w["tocc"]._replace(density_grid_torso=_t(old))
    pose = w["ds"].pose(4)
    key, step = jax.random.PRNGKey(2), 16
    jnew = j_make_refresh(w["jt"], w["jrs"], 8)(
        jax.tree.map(jnp.asarray, params), jocc, jnp.asarray(pose), key,
        jnp.asarray(step, jnp.int32))
    tt = _port_torso(params)
    tnew = make_torso_grid_update(tt, w["trs"], 8)(
        tocc, _t(pose), jitter=_t(_jax_refresh_jitter(key, step)))
    jg = _n(jnew.density_grid_torso)
    tg = tnew.density_grid_torso.numpy()
    assert (tg > old * 0.95).any() and (tg == old * np.float32(0.95)).any()
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(tnew.mean_density_torso),
                               float(jnew.mean_density_torso), rtol=1e-5)
    # the head's state is not touched
    assert tnew.occ is tocc.occ and tnew.density_grid is tocc.density_grid


def test_torso_refresh_scatter_and_border_exact(tworld):
    """update_torso_grid with the same alpha values on both sides: the
    transposed scatter (cell (c0, c1) at row c1, column c0) and the 5x5
    max-pool padded with -inf (negative alphas against an old grid of -10,
    so zero padding would show at the border) equal JAX's and a numpy
    max-pool, exactly; the alpha function sees the jittered lattice."""
    w = tworld
    rng = np.random.default_rng(12)
    alphas = rng.uniform(-1.0, -0.1, GRID * GRID).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jitter = np.asarray(jax.random.uniform(key, (GRID * GRID, 2)))
    old = np.full((GRID, GRID), -10.0, np.float32)
    seen = {}

    def j_fn(xys, pose, c):
        seen["jax"] = np.asarray(xys)
        return jnp.asarray(alphas)

    def t_fn(xys, pose, c):
        seen["port"] = xys.numpy()
        return _t(alphas)

    jocc = w["jocc"]._replace(density_grid_torso=jnp.asarray(old))
    jnew = j_update_torso(j_fn, w["jrs"], jocc, None, None, key)
    tnew = update_torso_grid(t_fn, w["trs"], w["tocc"]._replace(
        density_grid_torso=_t(old)), None, None, _t(jitter))
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-7)
    tg, jg = tnew.density_grid_torso.numpy(), _n(jnew.density_grid_torso)
    np.testing.assert_array_equal(tg, jg)
    # numpy: transposed scatter, then the max over each 5x5 window that
    # lies inside the grid
    a = alphas.reshape(GRID, GRID).T
    ref = np.full_like(a, -np.inf)
    for i in range(GRID):
        for j in range(GRID):
            ref[i, j] = a[max(0, i - 2):i + 3, max(0, j - 2):j + 3].max()
    ref = np.maximum(old * np.float32(0.95), ref)
    np.testing.assert_array_equal(tg, ref)
    border = np.ones((GRID, GRID), bool)
    border[2:-2, 2:-2] = False
    assert (tg[border] < 0).all()
    assert float(tnew.mean_density_torso) == pytest.approx(float(tg.mean()),
                                                           rel=1e-6)


@pytest.fixture(scope="module")
def step_world(tworld):
    w = tworld
    tx = _capture(build_optimizer(lr=1e-2, lr_net=1e-3, iters=ITERS))
    step = jax.jit(j_make_torso_step(w["jt"], w["jrs"], tx, H=RES, W=RES,
                                     num_rays=N_RAYS, ind_dim_torso=8))
    b = w["ds"].frame(3)
    b = dict(b, bg_color=np.ones((RES, RES, 3), np.float32))
    return dict(tx=tx, step=step, batch=b)


def _tbatch(b):
    return {k: (int(v) if k == "index" else _t(v)) for k, v in b.items()}


@pytest.mark.parametrize("step", [0, 999])
def test_torso_step_matches_jax(tworld, step_world, step):
    """Loss, every gradient, the updated parameters and the EMA after one
    torso step against JAX's make_torso_train_step on the same pixels (the
    head is not part of either). From step 999 the step's new count is
    1,000 and the EMA moves by decay 0.95; from step 0 it stays."""
    w, sw = tworld, step_world
    params = _scaled_tables(w["params"], 13)
    rng = jax.random.PRNGKey(4)
    state = JState.create(jax.tree.map(jnp.asarray, params),
                          sw["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in sw["batch"].items()}
    js, jm = sw["step"](state, w["jocc"], jb, rng)
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
    m = fn(st, w["tocc"], _tbatch(sw["batch"]),
           draws={"inds": torch.from_numpy(np.array(inds))})
    assert st.step == step + 1 and int(m["grad_notfinite"]) == 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    init = params_from_jax(params)
    for name, p in tt.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(st.ema[name].numpy(), jema[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = not torch.equal(st.ema[name], init[name])
        assert moved == (step == 999 and not torch.equal(
            p.detach(), init[name])), name
