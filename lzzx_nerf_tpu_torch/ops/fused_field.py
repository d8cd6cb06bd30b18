"""The serving field for one frame (port of lzzx_nerf_tpu/ops/fused_field.py
with the triplane lookup and the SH basis in front of it) and its CUDA
kernel's wrapper.

The field's MLPs (aud_ch_att, eye_att, sigma_net, color_net) are evaluated
as one decomposition: per-frame constants (audio code, individual code,
eye value) fold into the weights once per frame (fold_frame_weights), and
the concatenated-input layers become K-split sums. On a CUDA tensor the
lookup of the three packed triplanes, the SH-4 basis and the stack run as
one hand-written kernel (csrc/fused_field.cu, the port of the Pallas
``_field_kernel``); on a CPU tensor they run as the plain PyTorch version
(field_reference: encode_triplanes, sh_encode, fused_field_reference),
which is also what the kernel is held to.

The hash head has no packed tables: its encoding enc_x [N, 36] comes from
grid_encode (plain PyTorch) and goes through the kernel's second entry,
which computes what the Pallas kernel computes from enc_x and the
directions (fused_field_enc_eval; plain version fused_field_reference of
enc_x and the SH basis).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .. import kernels
from .packed_triplane import DenseTriplaneSpec, encode_triplanes
from .sh import sh_encode


class FieldWeights(NamedTuple):
    """Raw per-model weights, [fan_in, fan_out] like the JAX package."""

    aud0: torch.Tensor    # [36, 64]
    aud1: torch.Tensor    # [64, 32]
    eye0: torch.Tensor    # [36, 16]
    eye1: torch.Tensor    # [16, 1]
    sig0x: torch.Tensor   # [36, 64]  sigma_net layer 0, enc_x rows
    sig0a: torch.Tensor   # [32, 64]  sigma_net layer 0, enc_w rows
    sig0e: torch.Tensor   # [64]      sigma_net layer 0, eye row
    sig1: torch.Tensor    # [64, 64]
    sig2: torch.Tensor    # [64, 65]
    col0s: torch.Tensor   # [16, 64]  color_net layer 0, SH rows
    col0g: torch.Tensor   # [64, 64]  color_net layer 0, geo rows
    col0i: torch.Tensor   # [ind_dim, 64]
    col1: torch.Tensor    # [64, 3]


class FrameWeights(NamedTuple):
    """Per-frame folded weights (fold_frame_weights)."""

    aud0: torch.Tensor
    aud1: torch.Tensor
    eye0: torch.Tensor
    eye1: torch.Tensor
    sig0x: torch.Tensor
    sig0a_f: torch.Tensor  # [32, 64] enc_a folded in
    v_eye: torch.Tensor    # [1, 64]  eye * sig0e
    sig1: torch.Tensor
    sig2: torch.Tensor
    col0s: torch.Tensor
    col0g: torch.Tensor
    bias_c: torch.Tensor   # [1, 64]  ind_code @ col0i
    col1: torch.Tensor


def extract_field_weights(field, in_dim: int = 36,
                          audio_dim: int = 32) -> FieldWeights:
    """Pull the MLP weights out of a NeRFField, transposed back to the
    [fan_in, fan_out] layout the decomposition is written in. A field
    without the eye branch (exp_eye off: no eye_att_net, no eye row in
    sigma_net) gets zero eye0, eye1 and sig0e, so its eye term is 0 for
    any eye value (the JAX package's folded path has no such case: it
    reads eye_att_net and raises KeyError without it)."""
    def k(net, layer):
        return getattr(field, net).layer(layer).weight.detach().T.float()

    s0 = k("sigma_net", 0)
    c0 = k("color_net", 0)
    if getattr(field, "exp_eye", True):
        eye0, eye1 = k("eye_att_net", 0), k("eye_att_net", 1)
        sig0e = s0[in_dim + audio_dim]
    else:
        eye0 = s0.new_zeros((in_dim, 16))
        eye1 = s0.new_zeros((16, 1))
        sig0e = s0.new_zeros(s0.shape[1])
    return FieldWeights(
        aud0=k("aud_ch_att_net", 0), aud1=k("aud_ch_att_net", 1),
        eye0=eye0, eye1=eye1,
        sig0x=s0[:in_dim], sig0a=s0[in_dim:in_dim + audio_dim],
        sig0e=sig0e, sig1=k("sigma_net", 1),
        sig2=k("sigma_net", 2), col0s=c0[:16], col0g=c0[16:80],
        col0i=c0[80:], col1=k("color_net", 1))


def fold_frame_weights(w: FieldWeights, enc_a: torch.Tensor, ind_code,
                       eye) -> FrameWeights:
    """Fold the per-frame constants into the weights."""
    enc_a = enc_a.reshape(-1).float()
    if ind_code is not None:
        bias_c = ind_code.reshape(1, -1).float() @ w.col0i
    else:
        bias_c = torch.zeros((1, w.col0g.shape[1]), device=w.col0g.device)
    if eye is not None:
        e = torch.as_tensor(eye, dtype=torch.float32,
                            device=w.sig0e.device).reshape(())
    else:
        e = torch.zeros((), device=w.sig0e.device)
    return FrameWeights(
        aud0=w.aud0, aud1=w.aud1, eye0=w.eye0, eye1=w.eye1, sig0x=w.sig0x,
        sig0a_f=enc_a[:, None] * w.sig0a, v_eye=(e * w.sig0e)[None, :],
        sig1=w.sig1, sig2=w.sig2, col0s=w.col0s, col0g=w.col0g,
        bias_c=bias_c, col1=w.col1)


# the kernel's weight vector: name -> (offset, K, N), offsets in floats.
# A matrix [K, N] is zero-padded to multiples of 8, split into TF32 hi and
# lo parts (tf32_split) and stored in the m16n8k8 B-fragment order of
# csrc/fused_field.cu: block (k-tile j, n-tile m) holds, for lane 4g + t,
# the float4 (hi W[8j+2t][8m+g], hi W[8j+2t+1][8m+g], lo ..., lo ...), so
# a matrix takes 2 K N floats. Vectors (K None) are stored as they are.
# sig2 is split into its geo columns (a matrix) and its sigma column (a
# vector). Must match the O_* constants of csrc/fused_field.cu.
_W_LAYOUT = {
    "w_ae": (0, 40, 80),        # aud0 | eye0, enc_x rows padded 36 -> 40
    "aud1": (6400, 64, 32),
    "sig0x": (10496, 40, 64),
    "sig0a_f": (15616, 32, 64),
    "sig1": (19712, 64, 64),
    "sig2": (27904, 64, 64),    # sig2's geo columns 1..64
    "col0g": (36096, 64, 64),
    "col0s": (44288, 16, 64),
    "col1": (46336, 64, 8),
    "eye1": (47360, None, 16),
    "sigma": (47376, None, 64),  # sig2's sigma column 0
    "v_eye": (47440, None, 64),
    "bias_c": (47504, None, 64),
}
W_TOTAL = 47568


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero: what cvt.rna.tf32.f32 gives."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """The 3xTF32 split of a float32 tensor: hi = rna(x), lo = rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def _frame_matrices(fw: FrameWeights):
    """name -> the [K, N] (or [N]) float32 matrix packed under that name."""
    return {
        "w_ae": torch.cat([fw.aud0, fw.eye0], dim=1),
        "aud1": fw.aud1, "sig0x": fw.sig0x, "sig0a_f": fw.sig0a_f,
        "sig1": fw.sig1,
        "sig2": fw.sig2[:, 1:], "col0g": fw.col0g, "col0s": fw.col0s,
        "col1": fw.col1, "eye1": fw.eye1.reshape(-1),
        "sigma": fw.sig2[:, 0], "v_eye": fw.v_eye.reshape(-1),
        "bias_c": fw.bias_c.reshape(-1),
    }


def pack_frame_weights(fw: FrameWeights) -> torch.Tensor:
    """FrameWeights -> the kernel's [W_TOTAL] float32 vector (_W_LAYOUT)."""
    w = torch.zeros(W_TOTAL, dtype=torch.float32, device=fw.sig1.device)
    for name, mat in _frame_matrices(fw).items():
        off, K, N = _W_LAYOUT[name]
        mat = mat.float()
        if K is None:
            w[off:off + mat.numel()] = mat
            continue
        pad = torch.zeros((K, N), dtype=torch.float32, device=w.device)
        pad[:mat.shape[0], :mat.shape[1]] = mat
        # k = 8j + 2t + p, n = 8m + g -> [j, m, g, t, hi/lo, p]
        frag = torch.stack(tf32_split(pad)).view(2, K // 8, 4, 2, N // 8, 8)
        w[off:off + 2 * K * N] = frag.permute(1, 4, 5, 2, 0, 3).reshape(-1)
    return w


def unpack_frame_weights(wpack: torch.Tensor, name: str):
    """What pack_frame_weights stored under `name`, read the way the kernel
    reads it: the padded [K, N] (hi, lo) pair of a matrix, or a vector."""
    off, K, N = _W_LAYOUT[name]
    if K is None:
        return wpack[off:off + N]
    frag = wpack[off:off + 2 * K * N].view(K // 8, N // 8, 8, 4, 2, 2)
    hl = frag.permute(4, 0, 3, 5, 1, 2).reshape(2, K, N)
    return hl[0], hl[1]


def fused_field_reference(fw: FrameWeights, enc_x: torch.Tensor,
                          shd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the field MLP stack: enc_x [N, 36], SH-4
    basis shd [N, 16] -> [N, 4] = (sigma, r, g, b)."""
    h_ae = torch.relu(enc_x @ torch.cat([fw.aud0, fw.eye0], dim=1))
    att = h_ae[:, :64] @ fw.aud1
    eye_att = torch.sigmoid(
        torch.sum(h_ae[:, 64:80] * fw.eye1.reshape(1, -1), dim=-1,
                  keepdim=True))
    h = enc_x @ fw.sig0x + att @ fw.sig0a_f + eye_att * fw.v_eye
    h = torch.relu(h)
    h = torch.relu(h @ fw.sig1) @ fw.sig2
    sigma = torch.exp(h[:, :1])
    hc = h[:, 1:] @ fw.col0g + shd @ fw.col0s + fw.bias_c
    rgb = torch.relu(hc) @ fw.col1
    color = torch.sigmoid(rgb) * 1.002 - 0.001
    return torch.cat([sigma, color], dim=-1)


def field_reference(fw: FrameWeights, pts: torch.Tensor, dirs: torch.Tensor,
                    tables: Dict[str, torch.Tensor], spec: DenseTriplaneSpec,
                    bound: float) -> torch.Tensor:
    """Plain PyTorch version of the field kernel: the triplane lookup, the
    SH-4 basis and the MLP stack -> [N, 4] = (sigma, r, g, b)."""
    return fused_field_reference(
        fw, encode_triplanes(pts.float(), tables, spec, bound),
        sh_encode(dirs.float(), 4))


# the only triplane layout the kernel reads (NeRFField's dense encoder)
KERNEL_SPEC = DenseTriplaneSpec()


def fused_field_cuda(pts: torch.Tensor, dirs: torch.Tensor,
                     xy: torch.Tensor, yz: torch.Tensor, xz: torch.Tensor,
                     bound: float, wpack: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA field kernel: pts, dirs [N, 3] float32; xy, yz, xz
    the bf16 packed tables [pack_res², packed_dim] of KERNEL_SPEC; wpack
    [W_TOTAL] float32 (pack_frame_weights); all contiguous on one CUDA
    device -> [N, 4] = (sigma, r, g, b)."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError("fused_field_cuda takes CUDA tensors")
    n = pts.shape[0]
    if n >= 2 ** 31:
        raise ValueError("fused_field_cuda: too many samples for int32")
    spec = KERNEL_SPEC
    table = (spec.pack_res ** 2, spec.packed_dim)
    checks = ((pts, (n, 3), torch.float32, 4),
              (dirs, (n, 3), torch.float32, 4),
              (xy, table, torch.bfloat16, 4), (yz, table, torch.bfloat16, 4),
              (xz, table, torch.bfloat16, 4),
              (wpack, (W_TOTAL,), torch.float32, 16))
    for t, shape, dtype, align in checks:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"fused_field_cuda: expected {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_field_cuda: expected a contiguous "
                             f"{shape}, got {tuple(t.shape)}")
        if t.data_ptr() % align:
            raise ValueError(f"fused_field_cuda: inputs must be {align}-byte "
                             "aligned")
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            kernels.launch("fused_field", pts.data_ptr(), dirs.data_ptr(),
                           xy.data_ptr(), yz.data_ptr(), xz.data_ptr(),
                           wpack.data_ptr(), out.data_ptr(), n, float(bound),
                           torch.cuda.current_stream(dev).cuda_stream)
    return out


def fused_field_enc_cuda(enc_x: torch.Tensor, dirs: torch.Tensor,
                         wpack: torch.Tensor) -> torch.Tensor:
    """Launch the field kernel's enc_x entry: enc_x [N, 36] float32, dirs
    [N, 3] float32, wpack [W_TOTAL] float32 (pack_frame_weights); all
    contiguous on one CUDA device, enc_x and wpack 16-byte aligned ->
    [N, 4] = (sigma, r, g, b)."""
    dev = enc_x.device
    if dev.type != "cuda":
        raise ValueError("fused_field_enc_cuda takes CUDA tensors")
    n = enc_x.shape[0]
    if n >= 2 ** 31:
        raise ValueError("fused_field_enc_cuda: too many samples for int32")
    checks = ((enc_x, (n, 36), torch.float32, 16),
              (dirs, (n, 3), torch.float32, 4),
              (wpack, (W_TOTAL,), torch.float32, 16))
    for t, shape, dtype, align in checks:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"fused_field_enc_cuda: expected {dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_field_enc_cuda: expected a contiguous "
                             f"{shape}, got {tuple(t.shape)}")
        if t.data_ptr() % align:
            raise ValueError(f"fused_field_enc_cuda: inputs must be "
                             f"{align}-byte aligned")
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            kernels.launch("fused_field_enc", enc_x.data_ptr(),
                           dirs.data_ptr(), wpack.data_ptr(), out.data_ptr(),
                           n, torch.cuda.current_stream(dev).cuda_stream)
    return out


def fused_field_enc_eval(fw: FrameWeights, enc_x: torch.Tensor,
                         dirs: torch.Tensor,
                         wpack: Optional[torch.Tensor] = None):
    """(sigma [N], color [N, 3]) from the encoding enc_x [N, 36] of points
    seen along dirs [N, 3]: the Pallas kernel's own function.

    The wrapper of the kernel's enc_x entry: a CUDA tensor runs the CUDA
    kernel (wpack is pack_frame_weights(fw), packed here when the caller
    has not), a CPU tensor runs the plain version (fused_field_reference
    of enc_x and the SH-4 basis), any other device raises."""
    if enc_x.device.type == "cuda":
        out = fused_field_enc_cuda(enc_x.float().contiguous(),
                                   dirs.float().contiguous(),
                                   pack_frame_weights(fw)
                                   if wpack is None else wpack)
    elif enc_x.device.type == "cpu":
        out = fused_field_reference(fw, enc_x.float(),
                                    sh_encode(dirs.float(), 4))
    else:
        raise ValueError(f"no field kernel for device {enc_x.device}")
    return out[:, 0], out[:, 1:4]


def fused_field_eval(fw: FrameWeights, pts: torch.Tensor, dirs: torch.Tensor,
                     tables: Dict[str, torch.Tensor], spec: DenseTriplaneSpec,
                     bound: float, wpack: Optional[torch.Tensor] = None):
    """(sigma [N], color [N, 3]) at points pts [N, 3] seen along dirs
    [N, 3], from the packed triplane tables {"xy", "yz", "xz"}.

    The kernel's wrapper: a CUDA tensor runs the CUDA kernel (bf16 tables of
    KERNEL_SPEC only; wpack is pack_frame_weights(fw), packed here when the
    caller has not), a CPU tensor runs the plain version (field_reference),
    any other device raises."""
    if pts.device.type == "cuda":
        if spec != KERNEL_SPEC:
            raise ValueError(f"the field kernel reads {KERNEL_SPEC}, "
                             f"got {spec}")
        out = fused_field_cuda(pts.float().contiguous(),
                               dirs.float().contiguous(),
                               tables["xy"], tables["yz"], tables["xz"],
                               bound, pack_frame_weights(fw)
                               if wpack is None else wpack)
    elif pts.device.type == "cpu":
        out = field_reference(fw, pts, dirs, tables, spec, bound)
    else:
        raise ValueError(f"no field kernel for device {pts.device}")
    return out[:, 0], out[:, 1:4]
