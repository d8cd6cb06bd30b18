"""Audio conditioning networks (port of lzzx_nerf_tpu/models/audio.py).

The public layout stays channels-last [B, T, C] like the JAX package; the
convolutions transpose to PyTorch's [B, C, T] internally. Conv layers are
named Conv_i / Dense_i like the flax modules so converted params load by
name. The port sets torch.backends.cudnn.allow_tf32 = False on import of
this module: cuDNN would otherwise run these float32 convolutions in TF32
(about three decimal digits), which the parity with the JAX float32
convolutions does not allow.

`dtype` is flax's compute dtype under param_dtype=float32 (see
models/mlp.py): with bfloat16 the window, the kernels and the biases are
cast at the call, each convolution and matmul is rounded to bfloat16 before
its bias is added, as flax adds it, and constants enter rounded to
bfloat16, as JAX's weak-typed Python scalars do."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

_LEAKY = 0.02
# the slope as JAX multiplies a bfloat16 array by it: rounded to bfloat16
_LEAKY_BF16 = float(torch.tensor(_LEAKY, dtype=torch.bfloat16))


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU with the JAX package's derivative at 0 (the slope-1
    side: jax.nn.leaky_relu is where(x >= 0, x, a * x)); F.leaky_relu takes
    the other side, and exact zeros are common here (zero-padded audio
    windows through zero-initialised biases)."""
    slope = _LEAKY_BF16 if x.dtype == torch.bfloat16 else _LEAKY
    return torch.where(x >= 0, x, slope * x)


def _affine(mod: nn.Module, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    """A Conv1d or Linear layer computed in `dtype` from its float32
    parameters (the float32 layer itself when dtype is float32)."""
    if dtype == torch.float32:
        return mod(x)
    w = mod.weight.to(dtype)
    if isinstance(mod, nn.Conv1d):
        y = F.conv1d(x, w, None, mod.stride, mod.padding)
        return y + mod.bias.to(dtype)[:, None]
    return F.linear(x, w) + mod.bias.to(dtype)


def _softmax(y: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax's sequence of operations, each rounded to y's dtype
    (torch.softmax rounds once); the float32 path keeps torch.softmax."""
    if y.dtype == torch.float32:
        return torch.softmax(y, dim=dim)
    u = torch.exp(y - y.amax(dim=dim, keepdim=True).detach())
    return u / u.sum(dim=dim, keepdim=True)


class AudioNet(nn.Module):
    """Per-frame audio window [B, T>=16, C_in] -> [B, dim_aud] through a
    strided conv pyramid (16 -> 8 -> 4 -> 2 -> 1) and a 2-layer head."""

    def __init__(self, dim_in: int, dim_aud: int = 32, win_size: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.win_size = win_size
        self.dtype = dtype
        chans = (dim_in, 32, 32, 64, 64)
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv1d(
                chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.Dense_0 = nn.Linear(64, 64)
        self.Dense_1 = nn.Linear(64, dim_aud)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.win_size // 2
        x = x[:, 8 - half: 8 + half, :].to(self.dtype).transpose(1, 2)
        for i in range(4):                                 # x: [B, C, T]
            x = _leaky_relu(_affine(getattr(self, f"Conv_{i}"), x,
                                    self.dtype))
        x = x.reshape(x.shape[0], -1)                      # T collapsed to 1
        x = _leaky_relu(_affine(self.Dense_0, x, self.dtype))
        return _affine(self.Dense_1, x, self.dtype)


class AudioAttNet(nn.Module):
    """[B, seq_len, dim_aud] -> [B, dim_aud] temporal attention pooling."""

    def __init__(self, dim_aud: int = 32, seq_len: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.seq_len = seq_len
        self.dtype = dtype
        chans = (dim_aud, 16, 8, 4, 2, 1)
        for i in range(5):
            self.add_module(f"Conv_{i}", nn.Conv1d(
                chans[i], chans[i + 1], 3, stride=1, padding=1))
        self.Dense_0 = nn.Linear(seq_len, seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype).transpose(1, 2)               # [B, C, seq]
        for i in range(5):
            y = _leaky_relu(_affine(getattr(self, f"Conv_{i}"), y,
                                    self.dtype))
        y = _affine(self.Dense_0, y.reshape(y.shape[0], self.seq_len),
                    self.dtype)
        y = _softmax(y, dim=1)[..., None]                  # [B, seq, 1]
        # the uncast input, as the flax module weighs it
        return torch.sum(y * x, dim=1)
