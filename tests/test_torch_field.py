"""The port's field kernel, held on the CPU: its plain version against the
JAX package, and a lane-by-lane model of the CUDA kernel's arithmetic.

- The plain version (triplane lookup + SH basis + MLP stack, what the CUDA
  kernel is held to on the card) against NeRFField.encode_x on bf16 packed
  tables followed by the Pallas field kernel in interpret mode.
- The packed weight vector the kernel receives, read the way the kernel
  reads it: a model of csrc/fused_field.cu that keeps every register of
  every lane (m16n8k8 fragments, the accumulator-to-operand hand-over, the
  quad reduction, the write-back) and computes each mma as the PTX
  instruction defines it. In float32 it matches fused_field_reference; with
  the 3xTF32 split (operands rounded to TF32 as cvt.rna does) it stays
  within the card's field tolerance on the trained weights and tables.
- The weight layout constants of the CUDA source against the packer's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models import NeRFField as JField
from lzzx_nerf_tpu.ops import fused_field as jff
from lzzx_nerf_tpu_torch.models import NeRFField as TField
from lzzx_nerf_tpu_torch.ops import fused_field as tff
from lzzx_nerf_tpu_torch.ops.sh import sh_encode
from lzzx_nerf_tpu_torch.serving.state_io import (load_trained_state,
                                                  params_from_jax)
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(ROOT, "trained", "production_state.pkl")
# float32 in both, differing only in summation order (the tolerance of
# test_torch_models.py::test_folded_field_matches_pallas_kernel)
RTOL, ATOL = 2e-5, 1e-6
# the card's field tolerance (chip_smoke.py FIELD_TOL)
SIGMA_RTOL, SIGMA_ATOL, COLOR_ATOL = 1e-4, 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def random_field():
    """JAX NeRFField params from init with triplane levels drawn from a
    numpy seed, and the port's field loaded from them."""
    field = JField(bound=1.0, encoder="dense")
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                        jnp.ones((4, 3)) / np.sqrt(3.0),
                        jnp.zeros((8, 2, 1024)), jnp.zeros((4,)),
                        jnp.zeros((1,)), method="init_all")
    rng = np.random.default_rng(5)
    p = jax.tree_util.tree_map(np.asarray, params)
    for name in list(p["params"]):
        if name.startswith("encoder_"):
            p["params"][name] = rng.uniform(
                -0.5, 0.5, p["params"][name].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, p)
    tfield = TField(audio_in_dim=1024, ind_num=10_000)
    tfield.load_state_dict(params_from_jax(p))
    return field, params, tfield


def _frame(n, seed, reach):
    """n points in [-reach, reach]^3, unit directions, and a frame's audio
    code, individual code and eye value, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-reach, reach, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    enc_a = (rng.standard_normal((1, 32)) * 0.3).astype(np.float32)
    ind = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    return pts, d, enc_a, ind, np.asarray([0.25], np.float32)


@pytest.mark.parametrize("n", [1, 77, 300])
def test_field_plain_matches_jax_lookup_and_pallas(random_field, n):
    """field_reference (lookup + SH + MLP) on bf16 tables equals the JAX
    package's encode_x on its bf16 tables followed by the Pallas field
    kernel in interpret mode, at ragged N and with points outside the
    box (reach 1.3 > bound 1)."""
    field, params, tfield = random_field
    pts, d, enc_a, ind, eye = _frame(n, n, reach=1.3)
    assert (np.abs(pts) > 1.0).any(axis=-1).sum() > 0 or n == 1
    jpacked = field.apply(params, method="bake_tables", dtype=jnp.bfloat16)
    enc_x = field.apply(params, jnp.asarray(pts), packed=jpacked,
                        method="encode_x")
    jw = jff.fold_frame_weights(jff.extract_field_weights(params),
                                jnp.asarray(enc_a), jnp.asarray(ind),
                                jnp.asarray(eye))
    js, jc = jff.fused_field_eval(jw, enc_x, jnp.asarray(d), tile=128,
                                  interpret=True)
    tw = tff.fold_frame_weights(tff.extract_field_weights(tfield),
                                _t(enc_a), _t(ind), _t(eye))
    tables = tfield.bake_tables(torch.bfloat16)
    out = tff.field_reference(tw, _t(pts), _t(d), tables, tfield.dense_spec,
                              tfield.bound)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(js),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(jc),
                               rtol=RTOL, atol=ATOL)
    # and the wrapper takes the plain version on CPU tensors
    ws, wc = tff.fused_field_eval(tw, _t(pts), _t(d), tables,
                                  tfield.dense_spec, tfield.bound)
    assert torch.equal(ws, out[:, 0]) and torch.equal(wc, out[:, 1:])


# ---- a lane-by-lane model of csrc/fused_field.cu

LANE = torch.arange(32)
G_, T_ = LANE // 4, LANE % 4


def _tf32(x):
    """cvt.rna.tf32.f32 (round to 10 mantissa bits, ties away from zero),
    written out here independently of the package's tf32_rna."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(c, a, b):
    """mma.sync m16n8k8 (row.col) on register fragments, as PTX defines
    it: c, a [T, 32, 4], b [32, 2] -> the new c."""
    T = c.shape[0]
    A = torch.empty(T, 16, 8)
    A[:, G_, T_], A[:, G_ + 8, T_] = a[..., 0], a[..., 1]
    A[:, G_, T_ + 4], A[:, G_ + 8, T_ + 4] = a[..., 2], a[..., 3]
    B = torch.empty(8, 8)
    B[T_, G_], B[T_ + 4, G_] = b[:, 0], b[:, 1]
    C = torch.empty(T, 16, 8)
    C[:, G_, 2 * T_], C[:, G_, 2 * T_ + 1] = c[..., 0], c[..., 1]
    C[:, G_ + 8, 2 * T_], C[:, G_ + 8, 2 * T_ + 1] = c[..., 2], c[..., 3]
    D = A @ B + C
    return torch.stack([D[:, G_, 2 * T_], D[:, G_, 2 * T_ + 1],
                        D[:, G_ + 8, 2 * T_], D[:, G_ + 8, 2 * T_ + 1]], -1)


class _Kernel:
    """The kernel's mlp_tile over T tiles of 16 staged rows at once."""

    def __init__(self, wpack, split):
        self.w = wpack
        self.split = split

    def off(self, name):
        return tff._W_LAYOUT[name][0]

    def ktile(self, c, a, name, NT, j):
        if self.split:
            ah, al = _split(a)
        for m in range(NT):
            i = self.off(name) + ((j * NT + m) * 32 + LANE) * 4
            bh = torch.stack([self.w[i], self.w[i + 1]], -1)
            bl = torch.stack([self.w[i + 2], self.w[i + 3]], -1)
            if self.split:
                c[m] = _mma(c[m], al, bh)
                c[m] = _mma(c[m], ah, bl)
                c[m] = _mma(c[m], ah, bh)
            else:
                c[m] = _mma(c[m], a, bh + bl)

    def layer(self, c, act, name, KT):
        for j in range(KT):
            self.ktile(c, act[j][..., [0, 2, 1, 3]], name, len(c), j)

    def layer_staged(self, c, tile, name):
        for j in range(5):
            k = 8 * j + 2 * T_
            a = torch.stack([tile[:, G_, k], tile[:, G_ + 8, k],
                             tile[:, G_, k + 1], tile[:, G_ + 8, k + 1]], -1)
            self.ktile(c, a, name, len(c), j)

    def sh_fragments(self, shd):
        """The SH A fragments as each lane builds them from its rows."""
        s0, s8 = shd[:, G_], shd[:, G_ + 8]          # [T, 32, 16]

        def pick(s, b):
            return torch.gather(s, 2, (b + 2 * T_).expand(s.shape[0], 32)
                                [..., None])[..., 0]

        return [torch.stack([pick(s0, b), pick(s8, b), pick(s0, b + 1),
                             pick(s8, b + 1)], -1) for b in (0, 8)]

    def init_acc(self, name, s0, s8, NT):
        out = []
        for m in range(NT):
            i = self.off(name) + 8 * m + 2 * T_
            b0, b1 = self.w[i], self.w[i + 1]
            out.append(torch.stack([s0 * b0, s0 * b1, s8 * b0, s8 * b1], -1))
        return out

    def __call__(self, enc_x, shd):
        n = enc_x.shape[0]
        T = -(-n // 16)
        tile = torch.zeros(T * 16, 40)
        tile[:n, :36] = enc_x
        tile = tile.view(T, 16, 40)
        sh = torch.zeros(T * 16, 16)
        sh[:n] = shd
        sh = sh.view(T, 16, 16)

        def zero(NT):
            return [torch.zeros(T, 32, 4) for _ in range(NT)]

        def relu(c):
            return [torch.relu(x) for x in c]

        h_ae = zero(10)
        self.layer_staged(h_ae, tile, "w_ae")
        h_ae = relu(h_ae)
        e1 = self.off("eye1")
        lo0, lo1 = self.w[e1 + 2 * T_], self.w[e1 + 2 * T_ + 1]
        hi0, hi1 = self.w[e1 + 8 + 2 * T_], self.w[e1 + 9 + 2 * T_]
        e = []
        for r in (0, 2):
            v = (h_ae[8][..., r] * lo0 + h_ae[8][..., r + 1] * lo1
                 + h_ae[9][..., r] * hi0 + h_ae[9][..., r + 1] * hi1)
            v = v + v[:, LANE ^ 1]
            v = v + v[:, LANE ^ 2]
            e.append(torch.sigmoid(v))
        att = zero(4)
        self.layer(att, h_ae, "aud1", 8)
        h = self.init_acc("v_eye", e[0], e[1], 8)
        self.layer_staged(h, tile, "sig0x")
        self.layer(h, att, "sig0a_f", 4)
        h = relu(h)
        h2 = zero(8)
        self.layer(h2, h, "sig1", 8)
        h2 = relu(h2)
        sg = self.off("sigma")
        sig = []
        for r in (0, 2):            # float32 dot over the lane's columns
            v = sum(h2[m][..., r] * self.w[sg + 8 * m + 2 * T_]
                    + h2[m][..., r + 1] * self.w[sg + 8 * m + 2 * T_ + 1]
                    for m in range(8))
            v = v + v[:, LANE ^ 1]
            sig.append(torch.exp(v + v[:, LANE ^ 2]))
        geo = zero(8)
        self.layer(geo, h2, "sig2", 8)
        one = torch.ones(T, 32)
        hc = self.init_acc("bias_c", one, one, 8)
        self.layer(hc, geo, "col0g", 8)
        for j, a in enumerate(self.sh_fragments(sh)):
            self.ktile(hc, a, "col0s", 8, j)
        hc = relu(hc)
        rgb = zero(1)
        self.layer(rgb, hc, "col1", 8)
        rgb = torch.sigmoid(rgb[0]) * 1.002 - 0.001

        # lane t == 0 writes rows g and g + 8, blue from lane t == 1
        blue = rgb[:, (LANE + 1) % 32]
        out = torch.zeros(T, 16, 4)
        t0 = T_ == 0
        g0 = G_[t0]
        out[:, g0, 0], out[:, g0 + 8, 0] = sig[0][:, t0], sig[1][:, t0]
        out[:, g0, 1], out[:, g0, 2] = rgb[:, t0, 0], rgb[:, t0, 1]
        out[:, g0 + 8, 1], out[:, g0 + 8, 2] = rgb[:, t0, 2], rgb[:, t0, 3]
        out[:, g0, 3], out[:, g0 + 8, 3] = blue[:, t0, 0], blue[:, t0, 2]
        return out.reshape(T * 16, 4)[:n]


@pytest.mark.parametrize("n", [16, 250])
def test_packed_weights_as_the_kernel_reads_them(random_field, n):
    """The kernel's data flow on the packed weight vector, in float32,
    matches fused_field_reference: the fragment order, the sig2 column
    order, the padding and the register hand-over between layers are all
    what the plain version means."""
    _, _, tfield = random_field
    pts, d, enc_a, ind, eye = _frame(n, 40 + n, reach=1.0)
    tw = tff.fold_frame_weights(tff.extract_field_weights(tfield),
                                _t(enc_a), _t(ind), _t(eye))
    enc_x = tfield.encode_x(_t(pts), tfield.bake_tables(torch.bfloat16))
    shd = sh_encode(_t(d), 4)
    got = _Kernel(tff.pack_frame_weights(tw), split=False)(enc_x, shd)
    want = tff.fused_field_reference(tw, enc_x, shd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    # the vector holds exactly the folded weights as TF32 hi + lo (rounded
    # as cvt.rna does), padded with zeros
    wp = tff.pack_frame_weights(tw)
    for name, mat in tff._frame_matrices(tw).items():
        full = tff.unpack_frame_weights(wp, name)
        if mat.dim() == 1:
            assert torch.equal(full, mat)
            continue
        K, N = mat.shape
        for part, want in zip(full, _split(mat)):
            assert torch.equal(part[:K, :N], want), name
            assert not part[K:].any() and not part[:, N:].any(), name


def test_3xtf32_on_trained_weights_within_card_tolerance():
    """The kernel's 3xTF32 arithmetic (operands split into TF32 hi + lo as
    cvt.rna rounds them, lo*hi + hi*lo + hi*hi, float32 sums) on the
    trained weights and bf16 tables, at 4096 points inside the model's box,
    stays within the card's field tolerance of fused_field_reference."""
    st = load_trained_state(STATE)
    meta = st["meta"]
    head = st["head"]
    field = TField(audio_in_dim=int(meta["audio_dim"]),
                   ind_num=int(np.asarray(head["individual_codes"]).shape[0]))
    field.load_state_dict(params_from_jax(head))
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(meta["aabb"][:3]), np.asarray(meta["aabb"][3:])
    n = 4096
    pts = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    auds = rng.standard_normal((8, 16, int(meta["audio_dim"]))).astype(
        np.float32)
    with torch.no_grad():
        enc_a = field.encode_audio(_t(auds))
        tw = tff.fold_frame_weights(tff.extract_field_weights(field), enc_a,
                                    field.individual_codes[0], 0.25)
        enc_x = field.encode_x(_t(pts), field.bake_tables(torch.bfloat16))
    shd = sh_encode(_t(d), 4)
    got = _Kernel(tff.pack_frame_weights(tw), split=True)(enc_x, shd)
    want = tff.fused_field_reference(tw, enc_x, shd)
    assert torch.isfinite(got).all()
    assert (want[:, 0] > 1.0).sum() > 100   # the box holds the head
    err = (got[:, 0] - want[:, 0]).abs()
    assert (err <= SIGMA_ATOL + SIGMA_RTOL * want[:, 0].abs()).all(), \
        float((err / (SIGMA_ATOL + SIGMA_RTOL * want[:, 0].abs())).max())
    assert float((got[:, 1:] - want[:, 1:]).abs().max()) <= COLOR_ATOL
    # single-pass TF32 would not do: the split is what keeps the error
    # within the tolerance (this is why the kernel pays three products per
    # tile)
    wp = tff.pack_frame_weights(tw)
    for name, (off, K, N) in tff._W_LAYOUT.items():
        if K is not None:       # keep hi, zero lo: the weights in TF32
            wp.view(-1)[off:off + 2 * K * N].view(-1, 4)[:, 2:] = 0
    rough = _Kernel(wp, split=False)(_tf32(enc_x), _tf32(shd))
    assert float((rough[:, 1:] - want[:, 1:]).abs().max()) > COLOR_ATOL


def test_weight_layout_matches_cuda_source():
    """The O_* offsets of csrc/fused_field.cu are the packer's, and the
    blocks tile the vector without gaps or overlaps."""
    src = open(os.path.join(ROOT, "lzzx_nerf_tpu_torch", "csrc",
                            "fused_field.cu")).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (O_\w+|W_TOTAL) = (\d+);", src)}
    names = {"O_WAE": "w_ae", "O_AUD1": "aud1", "O_SIG0X": "sig0x",
             "O_SIG0A": "sig0a_f", "O_SIG1": "sig1", "O_SIG2": "sig2",
             "O_COL0G": "col0g", "O_COL0S": "col0s", "O_COL1": "col1",
             "O_EYE1": "eye1", "O_SIGMA": "sigma", "O_VEYE": "v_eye",
             "O_BIASC": "bias_c"}
    assert consts.pop("W_TOTAL") == tff.W_TOTAL
    assert {names[k]: v for k, v in consts.items()} == {
        k: v[0] for k, v in tff._W_LAYOUT.items()}
    end = 0
    for off, K, N in sorted(tff._W_LAYOUT.values()):
        assert off == end
        end = off + (2 * K * N if K else N)
    assert end == tff.W_TOTAL
