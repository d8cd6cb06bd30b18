"""Evaluation meters (port of lzzx_nerf_tpu/train/metrics.py): PSNR,
LPIPS-alex over train/lpips.py, and the mouth landmark distance."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import lpips as lpips_mod


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


class LPIPSMeter:
    """Running LPIPS-alex: the pretrained weights of an npz when a path is
    given or found (lpips.default_weights_path), else the fixed random
    backbone, whose values are not comparable to official LPIPS (the
    report says which)."""

    def __init__(self, weights_path: Optional[str] = None, device=None):
        self.device = torch.device(device or "cpu")
        self.params = lpips_mod.get_params(weights_path, device=self.device)
        self.pretrained = lpips_mod.is_pretrained(weights_path)
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    @torch.no_grad()
    def update(self, pred, gt):
        # [H, W, 3] in [0, 1] -> [1, H, W, 3] in [-1, 1]
        p = torch.as_tensor(np.asarray(pred, np.float32),
                            device=self.device)[None] * 2 - 1
        g = torch.as_tensor(np.asarray(gt, np.float32),
                            device=self.device)[None] * 2 - 1
        self.V += float(lpips_mod.lpips(self.params, p, g)[0])
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        name = "LPIPS (alex)" if self.pretrained else "LPIPS (alex, rand-feat)"
        return f"{name} = {self.measure():.6f}"


class LMDMeter:
    """Mouth (or face) landmark distance. Needs a landmark backend:
    face_alignment (backend "fan") or dlib with its 68-point predictor;
    when neither is installed the meter reports n/a instead of failing
    the eval."""

    def __init__(self, backend: str = "fan",
                 dlib_predictor_path: str = "", region: str = "mouth"):
        if region not in ("mouth", "face"):
            raise ValueError(f"region must be mouth|face, got {region!r}")
        self.backend = backend
        self.region = region
        self.predictor = None
        self.detector = None
        try:
            if backend == "dlib":
                import dlib

                path = dlib_predictor_path or os.path.expanduser(
                    "~/.cache/lzzx/shape_predictor_68_face_landmarks.dat")
                if not os.path.exists(path):
                    raise ImportError(
                        f"dlib shape predictor not found at {path}")
                self.detector = dlib.get_frontal_face_detector()
                self.predictor = dlib.shape_predictor(path)
            else:
                import face_alignment

                self.predictor = face_alignment.FaceAlignment(
                    face_alignment.LandmarksType.TWO_D, flip_input=False)
        except ImportError:
            self.predictor = None
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def get_landmarks(self, img: np.ndarray):
        if self.predictor is None:
            return None
        u8 = np.asarray(img * 255, np.uint8)
        if self.backend == "dlib":
            faces = self.detector(u8, 1)
            if len(faces) == 0:
                return None
            shape = self.predictor(u8, faces[0])
            return np.array([[pt.x, pt.y] for pt in shape.parts()],
                            np.float32)
        lms = self.predictor.get_landmarks(u8)
        return None if not lms else lms[-1]

    def update(self, pred, gt):
        if self.predictor is None:
            return
        lp = self.get_landmarks(np.asarray(pred))
        lg = self.get_landmarks(np.asarray(gt))
        if lp is None or lg is None:
            return
        # the region's landmarks (mouth: 48:68 of the 68-point layout),
        # each set centred before the distance
        if self.region == "mouth":
            lp, lg = lp[48:68], lg[48:68]
        lp = lp - lp.mean(0)
        lg = lg - lg.mean(0)
        self.V += float(np.linalg.norm(lp - lg, axis=-1).mean())
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        if self.predictor is None:
            return "LMD = n/a (no landmark backend installed)"
        return f"LMD ({self.region}) = {self.measure():.6f}"
