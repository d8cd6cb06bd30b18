"""Identities trained with label audio features (emb) and without the eye
branch (exp_eye off), served by the port's InferenceSession against the
JAX session, on tests/test_torch_serving.py's 64² two-blob geometry (the
production plan) with a JAX field of each kind, written as the
workspace's production_state.pkl.

emb: the dataset's 29-wide features become labels (their argmax) in both
providers; the state's embedding sets the audio net's input width.
exp_eye off: the JAX session serves such a field only through the plain
flax apply (fused_field 0: its folded path reads eye_att_net and raises
KeyError without it); the port folds the field with zero eye weights, so
its eye term is 0, and is held to those frames.

Both: the resolved plan and budgets equal, the counters of every chunk
equal, the rgb24 bytes within one level (tests/test_torch_serving.py's
rule)."""

import os

import numpy as np
import pytest

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu_torch.serving.session import COUNTERS
from lzzx_nerf_tpu_torch.serving.streaming import NullSink
from test_serving import _make_session_workspace
from test_torch_serving import BASE, _port, write_state
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

KINDS = {"emb": (dict(emb=True), {}),
         "eyeless": (dict(exp_eye=False), dict(fused_field=0))}
PLAN = dict(infer_window_candidates=40, budget_frac=0.5, infer_chunk=2)


@pytest.fixture(scope="module", params=sorted(KINDS))
def identity(request, tmp_path_factory):
    """(kind, data, workspace, the JAX session over it)."""
    kind = request.param
    kw, jkw = KINDS[kind]
    root = tmp_path_factory.mktemp(kind)
    data, ws = _make_session_workspace(root, H=64, W=64, focal_mult=4.0,
                                       blob_occ=True, **kw)
    js = JSession(JConfig(**BASE, **kw, **jkw, **PLAN))
    js.load_model(data, ws)
    write_state(js, os.path.join(ws, "production_state.pkl"))
    return kind, data, ws, js


def test_identity_serves_as_jax(identity):
    kind, data, ws, js = identity
    ts = _port(data, ws, **KINDS[kind][0], **PLAN)
    assert ts.field.emb == (kind == "emb")
    assert ts.field.exp_eye == (kind == "emb")
    assert ts.march_plan == tuple(js.march_plan) == (2, "nb5w", True)
    assert (ts.k2, ts.bucket, ts.budget) == (js.k2, js._bucket, js.budget)
    jrec, trec = [], []
    get = JSession._get_render

    def get_render(fmt):
        render = get(js, fmt)

        def wrapped(*a):
            out = render(*a)
            jrec.append((np.asarray(out[1]), int(out[4]), int(out[5]),
                         int(out[6])))
            return out
        return wrapped

    js._get_render = get_render
    check = ts._check_chunk
    ts._check_chunk = lambda b, c, cnt, p: (trec.append(cnt.copy()),
                                            check(b, c, cnt, p))
    jf, tf = {}, {}
    # the dataset's own features (labels under emb) drive both
    js.run(NullSink(), max_frames=6,
           on_frame=lambda i, b: jf.__setitem__(i, np.asarray(b).copy()))
    ts.run(NullSink(), max_frames=6,
           on_frame=lambda i, b: tf.__setitem__(i, b.copy()))
    assert sorted(tf) == sorted(jf) == list(range(6))
    for i in jf:
        assert np.abs(tf[i].astype(int) - jf[i].astype(int)).max() <= 1
    assert any(int(f.max()) > 0 for f in tf.values())
    assert len(trec) == len(jrec) == 3
    for cnt, (acts, wm, rl, lg) in zip(trec, jrec):
        c = dict(zip(COUNTERS, cnt.T))
        assert list(c["n_active"]) == list(acts)
        assert (c["n_winmax"].max(), c["n_real"].max(),
                c["n_long"].max()) == (wm, rl, lg)
    # the budget escape fired at the same chunk in both
    assert (ts.budget, ts.rebuilds > 0) == (js.budget, True)


def test_identity_folded_weights(identity):
    """The folded serving weights: an emb field's equal JAX's (folded
    path and all); an eye-less field's are the fault the port does not
    copy: JAX's extract_field_weights raises KeyError (eye_att_net), the
    port's eye weights are zero."""
    import torch

    from lzzx_nerf_tpu.ops.fused_field import extract_field_weights
    from lzzx_nerf_tpu_torch.ops.fused_field import \
        extract_field_weights as t_extract

    kind, data, ws, js = identity
    ts = _port(data, ws, **KINDS[kind][0], **PLAN)
    w = t_extract(ts.field)
    if kind == "eyeless":
        with pytest.raises(KeyError, match="eye_att_net"):
            extract_field_weights(js.infer_params)
        assert not (w.eye0.any() or w.eye1.any() or w.sig0e.any())
        return
    jw = extract_field_weights(js.infer_params)
    for name, v in jw._asdict().items():
        torch.testing.assert_close(getattr(w, name),
                                   torch.from_numpy(np.asarray(v)),
                                   rtol=0, atol=0)
