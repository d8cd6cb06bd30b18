"""Bias-free ReLU MLP (port of lzzx_nerf_tpu/models/mlp.py).

Layers are named net_0..net_{L-1} like the flax module, so a converted
params tree (serving/state_io.params_from_jax) loads by name.

`dtype` is flax's compute dtype under param_dtype=float32: the parameters
stay float32, the input and each weight are cast to `dtype` at the call
(the gradient reaches the float32 parameter through the cast), and the
output is `dtype`."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        for layer in range(num_layers):
            fan_in = dim_in if layer == 0 else dim_hidden
            fan_out = dim_out if layer == num_layers - 1 else dim_hidden
            self.add_module(f"net_{layer}",
                            nn.Linear(fan_in, fan_out, bias=False))

    def layer(self, i: int) -> nn.Linear:
        return getattr(self, f"net_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            x = F.linear(x, self.layer(i).weight.to(self.dtype))
            if i != self.num_layers - 1:
                x = F.relu(x)
        return x
