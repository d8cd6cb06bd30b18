"""Alpha compositing (port of lzzx_nerf_tpu/ops/composite.py).

alpha_i = 1 - exp(-sigma_i * delta_i); T_i = prod_{j<i} (1 - alpha_j);
a step is processed iff T_i >= T_thresh (the reference's early exit).

The transmittance products associate as the JAX package's do, so T, and
with it the T >= T_thresh cut, is bit-equal to JAX's: jnp.cumprod
multiplies left to right (cumprod_seq), and under differentiation JAX
evaluates it as the parallel-prefix scan lax.associative_scan
(cumprod_scan). torch.cumprod associates otherwise (on the CPU it agrees
with the sequential product in about 68 % of rows of 8), which moves T by
an ulp, enough to flip the cut of a ray whose T sits at T_thresh."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeResult(NamedTuple):
    image: torch.Tensor            # [N, 3]
    depth: torch.Tensor            # [N]
    weights_sum: torch.Tensor      # [N]
    amb_aud_sum: torch.Tensor      # [N]
    amb_eye_sum: torch.Tensor      # [N]
    uncertainty_sum: torch.Tensor  # [N]
    weights: torch.Tensor          # [N, S]


def cumprod_seq(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last dim, left to right (jnp.cumprod's
    order)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] * x[..., i])
    return torch.stack(cols, dim=-1)


def cumprod_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last dim in the association of
    lax.associative_scan (JAX's cumprod under differentiation): pair
    neighbours, scan the pairs, fill in the even positions."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = cumprod_scan(x[..., 0:n - 1:2] * x[..., 1::2])
    even = (odd[..., :-1] if n % 2 == 0 else odd) * x[..., 2::2]
    even = torch.cat([x[..., :1], even], dim=-1)
    # interleave: even[0], odd[0], even[1], odd[1], ...
    k = odd.shape[-1]
    out = torch.stack([even[..., :k], odd], dim=-1).flatten(-2)
    return torch.cat([out, even[..., k:]], dim=-1)


def exclusive_cumprod(one_minus: torch.Tensor,
                      scan: bool = False) -> torch.Tensor:
    """[N, S] -> T with T[:, 0] = 1, T[:, i] = prod_{j<i} one_minus[:, j];
    scan=True associates as JAX's differentiated cumprod."""
    inc = (cumprod_scan if scan else cumprod_seq)(one_minus)
    return torch.cat([torch.ones_like(one_minus[:, :1]), inc[:, :-1]],
                     dim=-1)


def composite_rays(sigmas, rgbs, amb_aud, amb_eye, uncertainty, deltas, ts,
                   mask, T_thresh: float = 1e-4) -> CompositeResult:
    """The composite of the training and eval renders. A composite whose
    sigmas carry a gradient takes the scan order (the JAX package
    differentiates it), one without takes the sequential order."""
    maskf = mask.to(sigmas.dtype)
    alpha = (1.0 - torch.exp(-sigmas * deltas)) * maskf
    T = exclusive_cumprod(1.0 - alpha, scan=sigmas.requires_grad)
    procf = ((T >= T_thresh) & mask).to(sigmas.dtype)
    weights = alpha * T * procf
    return CompositeResult(
        image=torch.einsum("ns,nsc->nc", weights, rgbs),
        depth=torch.sum(weights * ts, dim=-1),
        weights_sum=torch.sum(weights, dim=-1),
        amb_aud_sum=torch.sum(amb_aud * procf, dim=-1),
        amb_eye_sum=torch.sum(amb_eye * procf, dim=-1),
        uncertainty_sum=torch.sum(weights * uncertainty, dim=-1),
        weights=weights)
