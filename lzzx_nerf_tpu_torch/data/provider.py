"""Dataset provider for preprocessed talking-head data (the port's copy of
lzzx_nerf_tpu/data/provider.py; host-side numpy, no device work).

It serves full frames (image, masks, background composites, pose, audio
window, eye state); the serving session reads the poses, intrinsics,
audio windows, eye areas, mirror index and background.

Dataset layout consumed:
  transforms_train.json / transforms_val.json   poses + intrinsics
  gt_imgs/<id>.jpg          head+bg ground truth
  torso_imgs/<id>.png       RGBA torso plate
  ori_imgs/<id>.lms         68-point landmarks
  bc.jpg                    background plate
  au.csv                    OpenFace AUs (AU45_r = blink)
  aud_hu.npy | aud_eo.npy | aud_ds.npy   audio features

Images are decoded with OpenCV, imported where an image is read: serving
with bg_img "white" or "black" reads none.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..utils.audio import get_audio_features_np
from ..utils.pose import nerf_matrix_to_ngp, smooth_camera_path


def _load_image(path: str, rgba: bool = False) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    code = cv2.COLOR_BGRA2RGBA if (rgba and img.shape[-1] == 4) else cv2.COLOR_BGR2RGB
    img = cv2.cvtColor(img, code)
    return img.astype(np.float32) / 255.0


def _rect_mask(H: int, W: int, rect) -> np.ndarray:
    """Rect [xmin, xmax, ymin, ymax] with x = image ROW (x-rects come
    from lms[:, 1])."""
    m = np.zeros((H, W), bool)
    xmin, xmax, ymin, ymax = [int(v) for v in rect]
    m[max(xmin, 0):max(xmax, 0), max(ymin, 0):max(ymax, 0)] = True
    return m


class NeRFDataset:
    """type: 'train' | 'val' | 'test' ('test' reads the val split, like the
    reference provider.py:355-358)."""

    def __init__(self, cfg: Config, type: str = "train", downscale: int = 1):
        self.cfg = cfg
        self.type = type
        self.root = cfg.path
        self.training = type in ("train", "all", "trainval")
        self.preload = cfg.preload

        split = "val" if type == "test" else type
        with open(os.path.join(self.root, f"transforms_{split}.json")) as f:
            transform = json.load(f)

        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = int(transform["cy"]) * 2 // downscale
            self.W = int(transform["cx"]) * 2 // downscale

        frames = transform["frames"]
        start, end = cfg.data_range
        if end == -1:
            end = len(frames)
        frames = frames[start:end]
        if type == "train":
            if cfg.part:
                frames = frames[::10]
            elif cfg.part2:
                frames = frames[:375]
        elif type == "val":
            frames = frames[:100]

        # audio features (provider.py:389-421)
        self.aud_features = None
        if not cfg.asr:
            if cfg.aud == "":
                name = {"esperanto": "aud_eo.npy", "deepspeech": "aud_ds.npy",
                        "hubert": "aud_hu.npy"}
                key = next((k for k in name if k in cfg.asr_model), None)
                aud_path = os.path.join(self.root, name.get(key, "aud.npy"))
            else:
                aud_path = cfg.aud
            feats = np.load(aud_path)
            if feats.ndim == 3:
                # [N, 16, C] stays time-major for our AudioNet ([B, T, C])
                feats = feats.astype(np.float32)
                if cfg.emb:
                    feats = feats.argmax(-1)
            else:
                assert cfg.emb, "label-only aud features require emb mode"
                feats = feats.astype(np.int32)
            self.aud_features = feats

        # AU45 blink (provider.py:424-426, 497-501)
        au_path = os.path.join(self.root, "au.csv")
        au_blink = None
        if cfg.exp_eye and not os.path.exists(au_path):
            # every frame would silently train/render at the 0.25 fallback
            # — the blink branch learns nothing and --fix_eye stops doing
            # anything, discovered only after a full run
            print(f"[WARN] {au_path} missing with exp_eye: all frames use "
                  "the constant 0.25 blink fallback (run OpenFace AU45 "
                  "extraction — preprocess task 7 / reference run-book)")
        if os.path.exists(au_path):
            import csv

            with open(au_path) as f:
                reader = csv.DictReader(f)
                cols = {k.strip(): k for k in reader.fieldnames}
                au_blink = np.array(
                    [float(row[cols["AU45_r"]]) for row in reader], np.float32)

        self.poses: List[np.ndarray] = []
        self.image_paths: List[str] = []
        self.torso_paths: List[str] = []
        self.aud_ids: List[int] = []
        self.face_rect, self.lhalf_rect, self.eye_rect, self.lips_rect = [], [], [], []
        self.eye_area: List[float] = []

        skipped = 0
        for f in frames:
            img_id = str(f["img_id"])
            f_path = os.path.join(self.root, "gt_imgs", img_id + ".jpg")
            if not os.path.exists(f_path):
                skipped += 1
                continue
            pose = np.array(f["transform_matrix"], np.float32)
            self.poses.append(nerf_matrix_to_ngp(pose, cfg.scale, cfg.offset))
            self.image_paths.append(f_path)
            self.torso_paths.append(
                os.path.join(self.root, "torso_imgs", img_id + ".png"))
            self.aud_ids.append(int(f.get("aud_id", f["img_id"])))

            # landmarks are in ORIGINAL pixel coordinates; scale into the
            # (possibly downscaled) H x W grid every rect below lives in
            lms = np.loadtxt(
                os.path.join(self.root, "ori_imgs", img_id + ".lms"))
            if downscale != 1:
                lms = lms / downscale
            lh_xmin, lh_xmax = int(lms[31:36, 1].min()), int(lms[:, 1].max())
            xmin, xmax = int(lms[:, 1].min()), int(lms[:, 1].max())
            ymin, ymax = int(lms[:, 0].min()), int(lms[:, 0].max())
            self.face_rect.append([xmin, xmax, ymin, ymax])
            self.lhalf_rect.append([lh_xmin, lh_xmax, ymin, ymax])

            if cfg.exp_eye:
                area = 0.25
                if au_blink is not None:
                    idx = min(int(f["img_id"]), len(au_blink) - 1)
                    area = float(np.clip(au_blink[idx], 0, 2) / 2)
                self.eye_area.append(area)
                exmin, exmax = int(lms[36:48, 1].min()), int(lms[36:48, 1].max())
                eymin, eymax = int(lms[36:48, 0].min()), int(lms[36:48, 0].max())
                self.eye_rect.append([exmin, exmax, eymin, eymax])

            if cfg.finetune_lips:
                lips = slice(48, 60)
                lxmin, lxmax = int(lms[lips, 1].min()), int(lms[lips, 1].max())
                lymin, lymax = int(lms[lips, 0].min()), int(lms[lips, 0].max())
                cx_, cy_ = (lxmin + lxmax) // 2, (lymin + lymax) // 2
                half = max(lxmax - lxmin, lymax - lymin) // 2
                self.lips_rect.append([
                    max(0, cx_ - half), min(self.H, cx_ + half),
                    max(0, cy_ - half), min(self.W, cy_ + half)])

        # background plate (provider.py:528-545)
        if cfg.bg_img == "white":
            bg = np.ones((self.H, self.W, 3), np.float32)
        elif cfg.bg_img == "black":
            bg = np.zeros((self.H, self.W, 3), np.float32)
        else:
            bg_path = cfg.bg_img or os.path.join(self.root, "bc.jpg")
            bg = _load_image(bg_path)
            if bg.shape[:2] != (self.H, self.W):
                import cv2

                bg = cv2.resize(bg, (self.W, self.H),
                                interpolation=cv2.INTER_AREA)
        self.bg_img = bg[..., :3]

        if skipped:
            # the reference warns per miss (provider.py:445); one summary
            # line here — and a clear error instead of np.stack's cryptic
            # 'need at least one array' when EVERY frame failed the check
            print(f"[WARN] skipped {skipped}/{len(frames)} frames with no "
                  f"gt_imgs/<id>.jpg under {self.root}")
        if not self.poses:
            raise FileNotFoundError(
                f"no usable frames: none of the {len(frames)} transforms "
                f"entries has a gt_imgs/<img_id>.jpg under {self.root} "
                "(wrong --path, or preprocessing task 3 never ran?)")
        self.poses = np.stack(self.poses, 0)
        if cfg.smooth_path:
            self.poses = smooth_camera_path(self.poses, cfg.smooth_path_window)

        # Dataset audio is paired to frames via aud_id (reference
        # provider.py:477 gathers `aud_features[min(f['aud_id'], ...)]` per
        # kept frame); windows are then taken over this per-frame sequence by
        # loader index. Without this, any split not starting at global frame 0
        # (val/test, --part, data_range) would fetch the wrong audio. Novel
        # audio (cfg.aud != "") stays raw: the loader walks it directly
        # (reference provider.py:199,259).
        if self.aud_features is not None and cfg.aud == "":
            ids = np.minimum(np.asarray(self.aud_ids, np.int64),
                             len(self.aud_features) - 1)
            self.aud_features = self.aud_features[ids]

        self.eye_area = np.asarray(self.eye_area, np.float32)
        if cfg.exp_eye and cfg.smooth_eye and len(self.eye_area):
            ori = self.eye_area.copy()
            for i in range(len(ori)):
                self.eye_area[i] = ori[max(0, i - 1):min(len(ori), i + 2)].mean()

        # intrinsics (provider.py:617-634)
        if "focal_len" in transform:
            fl_x = fl_y = transform["focal_len"] / downscale
        elif "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x, fl_y = fl_x or fl_y, fl_y or fl_x
        else:
            raise RuntimeError("no focal length in transforms json")
        # self.W/H are already downscaled; only json-sourced cx/cy need /downscale
        cx = transform["cx"] / downscale if "cx" in transform else self.W / 2
        cy = transform["cy"] / downscale if "cy" in transform else self.H / 2
        self.intrinsics = (float(fl_x), float(fl_y), float(cx), float(cy))

        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._rng = np.random.default_rng(cfg.seed)
        # live-trim bookkeeping: absolute frame index of aud_features[0]
        # (advanced by session.run_live; see audio_window)
        self.aud_offset = 0

    # -- sizing / replay ---------------------------------------------------

    @property
    def num_frames(self) -> int:
        return len(self.image_paths)

    def __len__(self) -> int:
        """Loader length (provider.py:749-760): test with novel audio runs for
        the audio's length; live streaming ping-pongs twice over the poses."""
        if self.training:
            return self.num_frames
        if self.aud_features is not None and self.cfg.aud != "":
            return len(self.aud_features)
        if self.aud_features is not None:
            return self.num_frames
        return 2 * self.num_frames

    def mirror_index(self, index: int) -> int:
        # ping-pong replay (provider.py:637-644)
        size = self.num_frames
        turn, res = index // size, index % size
        return res if turn % 2 == 0 else size - res - 1

    # -- frame assembly ----------------------------------------------------

    def _load_frame_arrays(self, fi: int) -> Dict[str, np.ndarray]:
        if self.preload > 0 and fi in self._cache:
            return self._cache[fi]
        image = _load_image(self.image_paths[fi])[..., :3]
        torso = _load_image(self.torso_paths[fi], rgba=True)
        if image.shape[:2] != (self.H, self.W):
            # downscale != 1 (or mismatched source files): everything
            # downstream — bg plate, intrinsics, landmark rects — is in
            # (H, W) coordinates, so the pixels must follow
            import cv2

            image = cv2.resize(image, (self.W, self.H),
                               interpolation=cv2.INTER_AREA)
            torso = cv2.resize(torso, (self.W, self.H),
                               interpolation=cv2.INTER_AREA)
        # torso-over-background composite (provider.py:700-707)
        bg_torso = (torso[..., :3] * torso[..., 3:]
                    + self.bg_img * (1 - torso[..., 3:]))
        out = {"image": image, "bg_torso": bg_torso.astype(np.float32)}
        if self.preload > 0:
            self._cache[fi] = out
        return out

    def audio_window(self, index: int) -> np.ndarray:
        """[1 or 8, 16, C] attention window for (possibly novel-audio) frame
        index (reference utils.py get_audio_features). With dataset audio,
        self.aud_features was re-gathered per frame via aud_id in __init__.

        aud_offset (default 0) maps absolute frame indices into a TRIMMED
        feature buffer — session.run_live bounds memory for hours-long
        live streams by dropping frames that can never be windowed again
        and advancing this offset in lockstep."""
        return get_audio_features_np(self.aud_features, self.cfg.att,
                                     index - self.aud_offset)

    def frame(self, index: int) -> Dict[str, np.ndarray]:
        """Trainer batch dict for loader index `index` (full-frame layout)."""
        cfg = self.cfg
        auds = self.audio_window(index) if self.aud_features is not None else None
        fi = self.mirror_index(index) if not self.training else index
        arrays = self._load_frame_arrays(fi)

        # RAW per-frame blink value: the reference's training jitter
        # (±0.05, provider.py:690) is applied IN-GRAPH by the train step —
        # baking it here froze one jitter per frame under --preload
        # (device_frames caches frame() output once)
        eye = np.float32(self.eye_area[fi]) if cfg.exp_eye else np.float32(0)

        batch: Dict[str, np.ndarray] = {
            "image": arrays["image"],
            "pose": self.poses[fi],
            "eye": np.asarray([eye], np.float32),
            "index": np.int32(fi),
            "face_mask": _rect_mask(self.H, self.W, self.face_rect[fi]),
            # eye_mask/lhalf_mask deliberately NOT shipped: the reference
            # computes them (provider.py:683-693) and its train_step reads
            # them into locals that nothing ever uses
            # (TrainerUtil.py:194-195) — dead there, and two full H*W bool
            # uploads per step here
        }
        if auds is not None:
            batch["auds"] = auds
        # head stage bg = torso composite; torso stage bg = plain plate with
        # the composite as the target (provider.py:709-721)
        if cfg.torso:
            batch["bg_color"] = self.bg_img
            batch["bg_torso_color"] = arrays["bg_torso"]
        else:
            batch["bg_color"] = arrays["bg_torso"]
        if cfg.finetune_lips and self.training:
            r = self.lips_rect[fi]
            # static crop of side cfg.lips_crop centred on the lms lips rect
            pad = cfg.lips_crop
            cx_ = (r[0] + r[1]) // 2
            cy_ = (r[2] + r[3]) // 2
            oy = int(np.clip(cx_ - pad // 2, 0, max(self.H - pad, 0)))
            ox = int(np.clip(cy_ - pad // 2, 0, max(self.W - pad, 0)))
            batch["rect_origin"] = np.asarray([oy, ox], np.int32)
        return batch

    def frames(self, shuffle: Optional[bool] = None):
        order = np.arange(len(self))
        if shuffle if shuffle is not None else self.training:
            self._rng.shuffle(order)
        for i in order:
            yield self.frame(int(i))

    @property
    def has_gt(self) -> bool:
        return self.cfg.aud == ""
