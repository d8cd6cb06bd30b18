"""The loss stacks (port of lzzx_nerf_tpu/train/losses.py: head_losses,
torso_losses, binary_entropy, entropy_loss). Every stop_gradient of the
JAX package is a detach here."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..utils.clip import clip


def binary_entropy(alphas: torch.Tensor) -> torch.Tensor:
    """Elementwise binary entropy pushing weights/alphas to 0 or 1."""
    a = clip(alphas, 1e-5, 1 - 1e-5)
    return -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)


def entropy_loss(alphas: torch.Tensor) -> torch.Tensor:
    return torch.mean(binary_entropy(alphas))


def head_losses(outputs: Dict, pred_rgb: torch.Tensor, gt_rgb: torch.Tensor,
                face_mask: torch.Tensor, step_factor: float,
                unc_loss: bool = True, amb_aud_loss: bool = True,
                amb_eye_loss: bool = True, lambda_amb: float = 1e-4,
                max_steps: int = 16, finetune_lips_active: bool = False,
                ray_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-step scalar loss without LPIPS and the jitter regulariser.
    The lips finetune (finetune_lips_active) drops the uncertainty terms.

    ray_weight [N]: the compact path's per-ray loss weights (0 for budget
    overflow rays, n_active/n_slotted for slotted active rays, 1
    elsewhere); every mean becomes a weighted mean. The uncertainty
    softmax runs over the whole ray batch."""
    N = pred_rgb.shape[0]
    face = face_mask.to(torch.float32)
    if ray_weight is None:
        vmean = torch.mean
    else:
        v = ray_weight.to(torch.float32)
        denom = clip(torch.sum(v), 1.0)

        def vmean(x):
            return torch.sum(x * v) / denom

    loss = torch.mean((pred_rgb - gt_rgb) ** 2, dim=-1)             # [N]
    if unc_loss and not finetune_lips_active:
        alpha = 0.2
        uncertainty = outputs["uncertainty"]
        unc_weight = torch.softmax(uncertainty, dim=0) * N
        scale = alpha + (1 - alpha) * clip(
            (1 - step_factor) + step_factor * unc_weight.detach(), 0.0, 10.0)
        loss = loss * scale
        beta = uncertainty + 1.0
        norm_rgb = torch.linalg.vector_norm(pred_rgb - gt_rgb,
                                            dim=-1).detach()
        loss_u = norm_rgb / (2 * beta ** 2) + (torch.log(beta) ** 2) / 2
        loss = loss + step_factor * loss_u * face
        loss = loss + 1e-3 * step_factor * (uncertainty * (1.0 - face))

    total = vmean(loss)
    total = total + 1e-4 * vmean(binary_entropy(outputs["weights_sum"]))
    lam = step_factor * lambda_amb
    if amb_aud_loss:
        total = total + lam * vmean(outputs["ambient_aud"] * (1.0 - face))
    if amb_eye_loss:
        amb_eye = outputs["ambient_eye"] / max_steps
        total = total + lam * vmean(
            amb_eye * outputs["ambient_aud"].detach() * face)
    return total


def torso_losses(pred_rgb: torch.Tensor, gt_rgb: torch.Tensor,
                 torso_alpha: torch.Tensor,
                 anchor_points: torch.Tensor) -> torch.Tensor:
    """The torso stage's loss: MSE of the composite [N, 3] against the
    target, the anchors' homogeneous coordinate held at 1, and the
    alphas' [N, 1] binary entropy at 1e-4."""
    loss = torch.mean((pred_rgb - gt_rgb) ** 2)
    loss = loss + torch.mean((1.0 - anchor_points[:, 3]) ** 2)
    return loss + 1e-4 * entropy_loss(torso_alpha)
