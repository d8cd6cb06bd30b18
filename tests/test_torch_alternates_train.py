"""The port's head training step with label audio features (emb) and
without the eye branch (exp_eye off) against the JAX package's, on the
CPU, on the same draws, at tests/test_torch_train_step.py's sizes and
tolerances; and the parameter carriage around them: the embedding and an
absent eye_att_net through state_io and utils/convert, and the
embedding's optimizer group.

emb: the synthetic dataset's features as labels (their argmax), looked up
in the field's embedding [29, 29] before the audio net. exp_eye off: the
field has no eye_att_net and sigma_net reads no eye column; the step
draws no blink jitter (JAX splits its key anyway)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.train.optim import param_label_fn as j_label
from lzzx_nerf_tpu.utils import convert as jconvert
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.serving.state_io import (params_from_jax,
                                                  params_to_jax)
from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                       make_eval_step, make_train_step)
from lzzx_nerf_tpu_torch.train.optim import param_label_fn
from lzzx_nerf_tpu_torch.utils import convert
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (ITERS, LOSS_RTOL, N_RAYS, PARAM_ATOL,
                                   PARAM_RTOL, S, _assert_grad_close,
                                   _jax_draws, _tbatch, _tdraws,
                                   world)  # noqa: F401

KINDS = {"emb": dict(emb=True), "eyeless": dict(exp_eye=False)}


def _batch(w, kind):
    b = dict(w["batch"])
    if kind == "emb":
        b["auds"] = np.asarray(b["auds"]).argmax(-1).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def alt(world):
    """Per kind: the JAX field, its init parameters and jitted full and
    compacted steps over the world's data and occupancy."""
    w = world
    out = {}
    for kind, kw in KINDS.items():
        field = JField(audio_in_dim=w["ds"].audio_dim, att=2, ind_dim=4,
                       ind_num=64, **{"exp_eye": True, **kw})
        b0 = _batch(w, kind)
        params = field.init(
            jax.random.PRNGKey(0), jnp.zeros((4, 3)),
            jnp.ones((4, 3)) / 3 ** 0.5, jnp.asarray(b0["auds"]),
            jnp.zeros(4), jnp.asarray([0.2]), method="init_all")
        common = dict(w["common"], exp_eye=kw.get("exp_eye", True))
        steps = {"full": jax.jit(j_make_step(field, w["jrs"], w["tx"],
                                             **common)),
                 "compact": jax.jit(j_make_step(
                     field, w["jrs"], w["tx"], train_budget=N_RAYS,
                     **common))}
        out[kind] = dict(field=field, params=params, steps=steps)
    return out


def _port_field(w, kind, params):
    tf = NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64, **KINDS[kind])
    tf.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tf


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_param_trees_match_jax(alt, world, kind):
    """The port's field has exactly the JAX field's parameters: the
    embedding under emb, no eye_att_net (and a 68-row sigma_net) without
    the eye branch; params_to_jax inverts params_from_jax."""
    params = alt[kind]["params"]
    tf = _port_field(world, kind, params)
    sd = dict(tf.state_dict())
    assert set(sd) == set(params_from_jax(jax.tree.map(np.asarray,
                                                       params)))
    if kind == "emb":
        assert tuple(sd["embedding.weight"].shape) == (29, 29)
    else:
        assert not any(k.startswith("eye_att_net") for k in sd)
        assert tuple(sd["sigma_net.net_0.weight"].shape) == (64, 68)
    back = params_to_jax(sd)
    flat_j = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("path", ["full", "compact"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_alt_step_matches_jax(alt, world, kind, path):
    """Loss, every gradient and the updated parameters after one step at
    step 32 (every loss term weighted, the regulariser fires)."""
    w, a = world, alt[kind]
    step = 32
    budget = N_RAYS if path == "compact" else 0
    rng = jax.random.PRNGKey(3)
    state = JState.create(a["params"], w["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    b = _batch(w, kind)
    js, jm = a["steps"][path](state, w["jocc"],
                              {k: jnp.asarray(v) for k, v in b.items()},
                              rng)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    tf = _port_field(w, kind, a["params"])
    st = TrainState.create(tf, HeadOptimizer(tf.named_parameters(), 1e-2,
                                             1e-3, ITERS))
    st.step = step
    fn = make_train_step(tf, w["trs"], train_budget=budget,
                         exp_eye=KINDS[kind].get("exp_eye", True),
                         **w["common"])
    draws = _jax_draws(rng, step, (budget or N_RAYS) * S)
    m = fn(st, w["tocc"], _tbatch(b), draws=_tdraws(draws))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    if budget:
        assert int(m["n_active"]) == int(jm["n_active"])
    for name, p in tf.named_parameters():
        _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)
        if not name.startswith("encoder_"):
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_eyeless_eval_ignores_the_eye(alt, world):
    """make_eval_step(exp_eye=False): the eye value changes nothing and the
    ambient-eye map is zero."""
    w = world
    tf = _port_field(w, "eyeless", alt["eyeless"]["params"])
    st = TrainState.create(tf, HeadOptimizer(tf.named_parameters()))
    ev = make_eval_step(tf, w["trs"], H=w["ds"].H, W=w["ds"].W,
                        intrinsics=w["ds"].intrinsics, exp_eye=False)
    outs = []
    for eye in (0.1, 0.9):
        b = _tbatch(w["batch"])
        b["eye"] = torch.tensor([eye])
        outs.append(ev(st, w["tocc"], b))
    torch.testing.assert_close(outs[0]["image"], outs[1]["image"], rtol=0,
                               atol=0)
    assert float(outs[0]["ambient_eye"].abs().max()) == 0.0


def test_embedding_optimizer_group():
    """The embedding trains in the net group (lr_net, no weight decay), as
    the JAX package's param_label_fn puts it."""
    path = (jax.tree_util.DictKey("params"), jax.tree_util.DictKey(
        "embedding"), jax.tree_util.DictKey("embedding"))
    assert j_label(path, None) == "net" == param_label_fn("embedding.weight")
    field = NeRFField(audio_in_dim=29, ind_num=4, emb=True)
    opt = HeadOptimizer(field.named_parameters(), 1e-2, 1e-3, 10)
    net = opt.groups["net"]
    assert any(p is field.embedding.weight for p in net["params"])
    assert (net["lr"], net["wd"]) == (1e-3, 0.0)


def _reference_sd(emb: bool, eye: bool, seed: int = 2):
    """A reference-layout head state dict of NeRFField(encoder="hash")'s
    widths (deepspeech), with or without the embedding and eye net."""
    field = NeRFField(audio_in_dim=29, ind_num=4, encoder="hash", emb=emb,
                      exp_eye=eye).init_params(
        torch.Generator().manual_seed(seed))
    return field, convert.export_reference_state_dict(field.state_dict())


@pytest.mark.parametrize("emb,eye", [(True, True), (False, False),
                                     (True, False)])
def test_reference_conversion_carries_branches(emb, eye):
    """utils/convert carries the embedding and tolerates a missing
    eye_att_net both ways; the round trip is bit for bit. JAX's
    converter reads the same reference keys for every tensor it has
    (it drops the embedding and requires the eye net)."""
    field, sd = _reference_sd(emb, eye)
    assert ("embedding.weight" in sd) == emb
    assert any(k.startswith("eye_att_net.") for k in sd) == eye
    back = convert.convert_reference_state_dict(sd)
    own = field.state_dict()
    assert set(back) == set(own) - {"camera_dR", "camera_dT"}
    for k, v in back.items():
        assert torch.equal(v, own[k]), k
    if eye:
        jtree = jconvert.convert_reference_state_dict(
            {k: v.numpy() for k, v in sd.items()})
        want = params_from_jax(jtree)
        for k, v in want.items():
            assert torch.equal(back[k], v), k
