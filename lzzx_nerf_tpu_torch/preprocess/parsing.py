"""Task 4: semantic face parsing -> color-coded PNGs (the port's copy of
lzzx_nerf_tpu/preprocess/parsing.py; the TorchScript parser runs on the
parser's device, "cuda" unless named).

Reference backend is ModelScope M2FP multi-human parsing
(data_utils/face_parsing_by_m2fp/m2fp.py:36-114). This module keeps the same
on-disk contract — per-frame PNGs whose RGB content is
    head (face+hair) = blue  (0, 0, 255)
    neck             = green (0, 255, 0)
    torso/clothes    = red   (255, 0, 0)
    background       = white (255, 255, 255)
(the downstream tasks read them with cv2/BGR, so head tests channel-0==255
there) — behind pluggable backends:

1. a TorchScript segmentation model (``LZZX_PARSER_TS`` or `ts_path`):
   float32 [1, 3, H, W] RGB in [0, 1] -> [1, C, H, W] logits over the
   19-class CelebAMask-HQ convention (BiSeNet face parsers export this way);
2. ModelScope M2FP when the package is importable (the reference's own
   backend, label-name based).

Masks are dilated 3x3 before painting, like the reference (m2fp.py:45-46),
so the head/neck/torso seams have no white gaps.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional

import numpy as np

# CelebAMask-HQ 19-class convention (BiSeNet face parsing):
# 0 bg, 1 skin, 2 l_brow, 3 r_brow, 4 l_eye, 5 r_eye, 6 eyeglass, 7 l_ear,
# 8 r_ear, 9 earring, 10 nose, 11 mouth, 12 u_lip, 13 l_lip, 14 neck,
# 15 necklace, 16 cloth, 17 hair, 18 hat
HEAD_CLASSES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 17, 18)
NECK_CLASSES = (14, 15)
TORSO_CLASSES = (16,)


def _dilate(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    from scipy.ndimage import binary_dilation

    ellipse = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
    return binary_dilation(mask, structure=ellipse, iterations=iterations)


def color_code(labels: np.ndarray) -> np.ndarray:
    """Class-label map [H, W] -> color-coded RGB uint8 [H, W, 3] in the
    reference's palette, with the reference's seam-closing dilation."""
    head = _dilate(np.isin(labels, HEAD_CLASSES))
    neck = _dilate(np.isin(labels, NECK_CLASSES))
    torso = _dilate(np.isin(labels, TORSO_CLASSES))
    out = np.full((*labels.shape, 3), 255, np.uint8)       # white bg
    # paint back-to-front so head wins at dilated seams (the reference
    # paints face last over neck/clothes via successive replaces)
    out[torso] = (255, 0, 0)
    out[neck] = (0, 255, 0)
    out[head] = (0, 0, 255)
    return out


class FaceParser:
    """Pluggable face/body parser producing CelebAMask-HQ label maps."""

    def __init__(self, ts_path: Optional[str] = None,
                 backend_fn: Optional[Callable] = None, device=None):
        self.backend: Optional[Callable[[np.ndarray], np.ndarray]] = None
        self.name = "none"
        if backend_fn is not None:
            self.backend = backend_fn
            self.name = "custom"
            return
        ts_path = ts_path or os.environ.get("LZZX_PARSER_TS")
        if ts_path and os.path.exists(ts_path):
            self._init_torchscript(ts_path, device)
            return
        try:
            self._init_modelscope()
        except Exception:
            raise RuntimeError(
                "no face-parsing backend available. Get one with "
                "scripts/get_parsing_model.py: `bisenet --weights "
                "79999_iter.pth` converts the pinned CelebAMask-HQ BiSeNet "
                "(zllrunning/face-parsing.PyTorch) to a TorchScript parser "
                "(then export LZZX_PARSER_TS=<out>), or `modelscope` warms "
                "the reference's M2FP pipeline (needs pip install "
                "modelscope). Alternatively drop precomputed color-coded "
                "PNGs into the parsing/ directory")

    def _init_torchscript(self, path: str, device=None) -> None:
        import torch

        from ..utils.device import resolve_device

        dev = resolve_device(device)
        module = torch.jit.load(path, map_location=dev).eval()

        def run(img_rgb: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(
                img_rgb.astype(np.float32).transpose(2, 0, 1)[None] / 255.0)
            with torch.no_grad():
                logits = module(x.to(dev))
            if isinstance(logits, (list, tuple)):
                logits = logits[0]
            return logits[0].argmax(0).cpu().numpy().astype(np.int32)

        self.backend = run
        self.device = dev
        self.name = f"torchscript:{os.path.basename(path)}"

    def _init_modelscope(self) -> None:
        from modelscope.outputs import OutputKeys
        from modelscope.pipelines import pipeline
        from modelscope.utils.constant import Tasks

        pipe = pipeline(Tasks.image_segmentation,
                        "damo/cv_resnet101_image-multiple-human-parsing")
        # M2FP emits named masks; translate to the class convention
        name_to_class = {"Face": 1, "Hair": 17, "Torso-skin": 14,
                         "UpperClothes": 16, "Coat": 16, "Left-arm": 16,
                         "Right-arm": 16, "Sunglasses": 6, "Scarf": 16,
                         "Skirt": 16, "Pants": 16, "Dress": 16, "Hat": 18}

        def run(img_rgb: np.ndarray) -> np.ndarray:
            res = pipe(img_rgb[..., ::-1])  # modelscope wants BGR
            labels = res[OutputKeys.LABELS]
            masks = res["masks"]
            out = np.zeros(img_rgb.shape[:2], np.int32)
            for name, m in zip(labels, masks):
                cls = name_to_class.get(name)
                if cls is not None:
                    out[np.asarray(m) > 0] = cls
            return out

        self.backend = run
        self.name = "modelscope:m2fp"

    def parse(self, img_rgb: np.ndarray) -> np.ndarray:
        """RGB uint8 [H, W, 3] -> CelebAMask-HQ label map [H, W] int32."""
        return self.backend(img_rgb)


def run_parsing(ori_dir: str, parsing_dir: str,
                parser: Optional[FaceParser] = None, device=None) -> int:
    """Parse every ori_imgs frame into parsing/<i>.png; returns the count.
    Without `parser`, a FaceParser on `device`."""
    import cv2

    parser = parser or FaceParser(device=device)
    os.makedirs(parsing_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(ori_dir, "*.jpg")))
    for p in paths:
        bgr = cv2.imread(p, cv2.IMREAD_COLOR)
        labels = parser.parse(bgr[..., ::-1])
        rgb = color_code(labels)
        out = os.path.join(parsing_dir,
                           os.path.basename(p).replace(".jpg", ".png"))
        cv2.imwrite(out, rgb[..., ::-1])  # store so the file content is RGB
    return len(paths)
