"""clip with the JAX package's gradient at the bounds."""

from __future__ import annotations

from typing import Optional

import torch


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """jnp.clip(x, lo, hi) as maximum-then-minimum, so a value exactly at a
    bound passes half the gradient (the tie rule of jnp.maximum and
    torch.maximum alike); torch.clamp would pass all of it."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x
