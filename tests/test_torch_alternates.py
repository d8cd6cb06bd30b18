"""The port's serving alternates against the JAX session, on
tests/test_torch_serving.py's 64² two-blob identity (the production plan:
group 2, nb5w, prepass, bucket march):

- infer_march_prepass off, infer_table_bf16 off (float32 tables: the
  plain lookup, then the field kernel's enc_x entry) and
  infer_sample_frac (stage-1 sample compaction; 0.05 overflows and the
  escape rebuilds): the resolved plans and budgets equal, the counters of
  every chunk equal (n_spts included), the rgb24 bytes within one level
  (tests/test_torch_serving.py's rule: the clipped image x 255 truncated,
  a pixel a float ulp either side of a level may differ by one);
- against the port itself, byte for byte: prepass off equals the
  unbucketed nb5w path, and the bucketed one on the JAX package's own
  fixture and plan (tests/test_serving.py's
  test_session_production_march_plan_bit_parity, the same 64² blob
  workspace), the sample compaction equals no compaction once its plan
  holds every marched sample;
- _staged_eval_composite with sample_budget against JAX's on a synthetic
  march (each sample's field value read from its position): n_spts equal,
  the image and weight sums within 1e-6 at a fitting budget and at one
  that overflows (the same samples dropped in both).

Stage 2 never truncates (tests/test_torch_serving.py's BASE)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.config import Config as JConfig
from lzzx_nerf_tpu.ops import march as jm
from lzzx_nerf_tpu.render import RenderSettings as JRS
from lzzx_nerf_tpu.render.renderer import _staged_eval_composite as j_staged
from lzzx_nerf_tpu.serving.session import InferenceSession as JSession
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.ops import march as tm
from lzzx_nerf_tpu_torch.render import RenderSettings as TRS
from lzzx_nerf_tpu_torch.render.renderer import \
    _staged_eval_composite as t_staged
from lzzx_nerf_tpu_torch.serving.session import COUNTERS, InferenceSession
from lzzx_nerf_tpu_torch.serving.streaming import NullSink
from test_torch_serving import BASE, _feats, _port, blob  # noqa: F401
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

LEVEL = 1
ALTS = {
    "prepass_off": dict(infer_march_prepass=False),
    "f32_tables": dict(infer_table_bf16=False),
    "sample_escape": dict(infer_sample_frac=0.05),
}


def _record(js, ts):
    """Per chunk: JAX's (n_active per frame, max n_stage2, n_spts,
    n_winmax, n_real, n_long) as its run loop fetches them, and the
    port's counters as its run loop checks them."""
    jrec, trec = [], []

    def get_render(fmt):
        render = JSession._get_render(js, fmt)

        def wrapped(*a):
            out = render(*a)
            _, acts, s2, sp, wm, rl, lg, _ = out
            jrec.append((np.asarray(acts), int(s2), int(sp), int(wm),
                         int(rl), int(lg)))
            return out
        return wrapped

    js._get_render = get_render
    check = ts._check_chunk

    def port_check(base, count, cnt, plan):
        trec.append(cnt.copy())
        check(base, count, cnt, plan)

    ts._check_chunk = port_check
    return jrec, trec


def _frames(s, feats, **kw):
    got = {}
    s.set_audio_features(feats)
    s.run(NullSink(), on_frame=lambda i, b: got.__setitem__(
        i, np.asarray(b).copy()), **kw)
    return got


@pytest.mark.parametrize("alt", sorted(ALTS))
def test_alternate_session_matches_jax(blob, alt):  # noqa: F811
    data, ws = blob
    plan = dict(ALTS[alt], infer_window_candidates=40, budget_frac=1.0,
                infer_chunk=2)
    js = JSession(JConfig(**BASE, **plan))
    js.load_model(data, ws)
    ts = _port(data, ws, **plan)
    assert ts.march_plan == tuple(js.march_plan)
    assert (ts.k2, ts.bucket, ts.budget, ts.sample_budget) == (
        js.k2, js._bucket, js.budget, js.sample_budget)
    jrec, trec = _record(js, ts)
    feats = _feats(6, 5)
    jf, tf = _frames(js, feats), _frames(ts, feats)
    assert sorted(tf) == sorted(jf) == list(range(6))
    for i in jf:
        assert np.abs(tf[i].astype(int) - jf[i].astype(int)).max() <= LEVEL
    assert len(trec) == len(jrec) == 3
    for cnt, (acts, s2, sp, wm, rl, lg) in zip(trec, jrec):
        c = dict(zip(COUNTERS, cnt.T))
        assert list(c["n_active"]) == list(acts)
        assert (c["n_stage2"].max(), c["n_spts"].max(), c["n_winmax"].max(),
                c["n_real"].max(), c["n_long"].max()) == (s2, sp, wm, rl, lg)
    assert (ts.budget, ts.sample_budget) == (js.budget, js.sample_budget)
    if alt == "sample_escape":
        assert ts.rebuilds >= 1 and ts.sample_budget > ts._sample_cap * 0.05
    if alt == "f32_tables":
        assert all(t.dtype == torch.float32 for t in ts.packed.values())


def test_prepass_off_equals_unbucketed_nb5w(blob):  # noqa: F811
    """Without the prepass, the same frames as the nb5w path without the
    bucket split, byte for byte (the prepass only drops blocks that keep
    no sample)."""
    data, ws = blob
    kw = dict(infer_window_candidates=40, budget_frac=1.0, infer_chunk=3)
    off = _port(data, ws, infer_march_prepass=False, **kw)
    on = _port(data, ws, infer_march_bucket=False, **kw)
    assert off.march_plan == (2, "nb5w", False)
    assert on.march_plan == (2, "nb5w", True) and on.bucket is None
    feats = _feats(4, 8)
    a, b = _frames(off, feats), _frames(on, feats)
    for i in range(4):
        np.testing.assert_array_equal(a[i], b[i])


# the plans of the bucketed-path check: tests/test_serving.py's (S 8, no
# stage split given, chunk 2) and this file's serving point (BASE, K2 40)
BUCKET_PLANS = {
    "jax_test": dict(asr_model="deepspeech", grid_size=32, max_steps=8,
                     infer_samples=8, infer_chunk=2, budget_frac=1.0),
    "serving_point": dict(BASE, infer_window_candidates=40,
                          budget_frac=1.0, infer_chunk=3),
}


@pytest.mark.parametrize("plan", sorted(BUCKET_PLANS))
def test_prepass_off_equals_bucketed_nb5w(blob, plan):  # noqa: F811
    """The JAX package's check of the production plan, on the port: the
    session with the prepass and the bucket march off streams the same
    bytes as the production plan (group 2, nb5w, prepass, a bucket split
    the blob's span spread makes), on JAX's own fixture, features and
    plan."""
    data, ws = blob
    feats = np.random.default_rng(31).standard_normal(
        (4, 16, 29)).astype(np.float32)

    def run(**kw):
        s = InferenceSession(Config(**BUCKET_PLANS[plan], **kw),
                             device="cpu", log=lambda m: None)
        s.load_model(data, ws)
        return s, _frames(s, feats)

    s_off, off = run(infer_march_prepass=False, infer_march_bucket=False)
    assert s_off.march_plan == (2, "nb5w", False)
    s_on, on = run()
    assert s_on.march_plan == (2, "nb5w", True)
    # the bucket split runs (JAX's test fails loudly when it does not)
    assert s_on.bucket is not None and s_on.bucket[0] >= 8
    assert sorted(on) == sorted(off) == list(range(4))
    for i in off:
        np.testing.assert_array_equal(on[i], off[i])


def test_sample_compaction_settles_byte_equal(blob):  # noqa: F811
    """After its escape settles, the compacted stage-1 eval renders the
    uncompacted session's bytes; at the full lattice it is a
    permutation and scatter and renders them from the first frame."""
    data, ws = blob
    kw = dict(infer_window_candidates=40, budget_frac=1.0, infer_chunk=3)
    feats = _feats(6, 9)
    base = _frames(_port(data, ws, **kw), feats)
    full = _port(data, ws, infer_sample_frac=1.0, **kw)
    assert full.sample_budget == full._sample_cap
    got = _frames(full, feats)
    for i in range(6):
        np.testing.assert_array_equal(got[i], base[i])
    tiny = _port(data, ws, infer_sample_frac=0.01, **kw)
    first = _frames(tiny, feats)
    assert tiny.rebuild_pending() or tiny.rebuilds >= 1
    again = _frames(tiny, feats)
    assert tiny.sample_budget > 0 and not tiny.rebuild_pending()
    for i in range(6):
        np.testing.assert_array_equal(again[i], base[i])
    assert any(not np.array_equal(first[i], base[i]) for i in range(3))


def _synthetic_march(B, S, seed):
    rng = np.random.default_rng(seed)
    ids = np.arange(B * S, dtype=np.float32).reshape(B, S)
    xyzs = np.stack([ids, np.zeros_like(ids), np.zeros_like(ids)], -1)
    mask = rng.random((B, S)) < 0.55
    deltas = np.where(mask, 0.05, 0.0).astype(np.float32)
    ts = np.cumsum(np.full((B, S), 0.05, np.float32), 1).astype(np.float32)
    sig = rng.uniform(0.0, 30.0, B * S).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (B * S, 3)).astype(np.float32)
    rd = np.tile(np.float32([0, 0, 1]), (B, 1))
    return xyzs, mask, deltas, ts, sig, rgb, rd


@pytest.mark.parametrize("budget", [4096, 300])
def test_staged_sample_compaction_matches_jax(budget):
    """Fitting (4,096 slots for about 2,250 marched stage-1 samples) and
    overflowing (300) sample budgets: n_spts equal, image and weight sums
    within 1e-6 (the same float32 products)."""
    B, S, split = 512, 16, 8
    xyzs, mask, deltas, ts, sig, rgb, rd = _synthetic_march(B, S, budget)

    class Out:
        def __init__(self, s, c):
            self.sigma, self.color = s, c

    def j_apply(params, pts, dirs, *a, **k):
        i = pts[:, 0].astype(jnp.int32)
        return Out(jnp.asarray(sig)[i], jnp.asarray(rgb)[i])

    def t_apply(pts, dirs):
        i = pts[:, 0].to(torch.int64)
        return torch.from_numpy(sig)[i], torch.from_numpy(rgb)[i]

    jres = jm.MarchResult(xyzs=jnp.asarray(xyzs), deltas=jnp.asarray(deltas),
                          ts=jnp.asarray(ts), mask=jnp.asarray(mask))
    tres = tm.MarchResult(*(torch.from_numpy(a) for a in (xyzs, deltas, ts,
                                                          mask)))
    j_img, j_ws, j_n2, j_sp = j_staged(j_apply, None, JRS(), jres,
                                       jnp.asarray(rd), None, None, None, B,
                                       S, split, B, sample_budget=budget)
    t_img, t_ws, t_n2, t_sp = t_staged(t_apply, TRS(), tres,
                                       torch.from_numpy(rd), B, S, split, B,
                                       sample_budget=budget)
    assert int(t_sp) == int(j_sp) == int(mask[:, :split].sum())
    assert int(t_n2) == int(j_n2)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-6)
    np.testing.assert_allclose(t_ws.numpy(), np.asarray(j_ws), atol=1e-6)
    if budget > int(mask[:, :split].sum()):
        # fitting: the uncompacted composite's own result
        u_img, u_ws, _, none = t_staged(t_apply, TRS(), tres,
                                        torch.from_numpy(rd), B, S, split, B)
        assert none is None
        torch.testing.assert_close(t_img, u_img, rtol=0, atol=0)
        torch.testing.assert_close(t_ws, u_ws, rtol=0, atol=0)
