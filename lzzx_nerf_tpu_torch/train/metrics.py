"""Evaluation meters (port of the PSNR part of
lzzx_nerf_tpu/train/metrics.py)."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


class PSNRMeter:
    """Running mean PSNR over the frames it is given."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, pred, gt):
        self.V += float(psnr(torch.as_tensor(pred), torch.as_tensor(gt)))
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"
