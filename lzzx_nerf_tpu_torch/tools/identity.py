"""Write a servable identity from a trained state: a dataset directory
whose poses and intrinsics are the state's, and a workspace that holds the
state, in the layout the HTTP server reads (<root>/<model> and
<root>/trial_<model>/production_state.pkl).

    python3 -m lzzx_nerf_tpu_torch.tools.identity --out DIR \\
        [--state trained/production_state.pkl] [--model identity] \\
        [--res 512] [--poses N] [--seed 0]

The dataset holds transforms_train.json and transforms_val.json (the
same frames: the state's intrinsics scaled to --res; each frame's
transform_matrix is the inverse of nerf_matrix_to_ngp at the Config's
scale and offset, so the loaded poses are the state's),
gt_imgs/<id>.jpg, torso_imgs/<id>.png (a seeded torso plate over the
lower third, so --test and the CLI's training load the frames) and
ori_imgs/<id>.lms (landmarks), au.csv (blinks), aud_ds.npy (seeded
29-wide features, one row per frame) and bc.jpg (a seeded background)
when OpenCV, the provider's image codec, is installed. Without it the
images are not written (the gt images are empty files: the provider
checks that they exist and reads none while serving) and the identity
serves with Config(bg_img="white"); write_identity says which.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from ..config import Config
from ..serving.state_io import load_trained_state

_STATE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "trained", "production_state.pkl")


def ngp_matrix_to_nerf(pose: np.ndarray, scale: float = 4.0,
                       offset=(0, 0, 0)) -> np.ndarray:
    """The inverse of utils.pose.nerf_matrix_to_ngp: a renderer pose ->
    the dataset's transform_matrix (exact for a power-of-two scale and a
    zero offset)."""
    p = np.asarray(pose, np.float64)
    return np.array([
        [p[2, 0], -p[2, 1], -p[2, 2], (p[2, 3] - offset[2]) / scale],
        [p[0, 0], -p[0, 1], -p[0, 2], (p[0, 3] - offset[0]) / scale],
        [p[1, 0], -p[1, 1], -p[1, 2], (p[1, 3] - offset[1]) / scale],
        [0.0, 0.0, 0.0, 1.0]])


def image_writer():
    """A function (path, uint8 [H, W, 3] RGB) -> None writing through
    OpenCV, the codec the provider reads images with, or None when OpenCV
    is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    # RGB(A) -> OpenCV's BGR(A)
    return lambda path, img: cv2.imwrite(
        path, np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[-1]]]))


def write_identity(out: str, state_path: str = _STATE,
                   model: str = "identity", res: Optional[int] = None,
                   n_poses: Optional[int] = None,
                   seed: int = 0) -> Dict[str, object]:
    """Write <out>/<model> (the dataset) and <out>/trial_<model> (the
    workspace, a copy of the state) over the state's first n_poses poses
    (default all). Returns {"data", "workspace",
    "poses" (the state's, what the dataset must load), "bg_img" ("" for
    bc.jpg, "white" without a codec), "codec"}."""
    st = load_trained_state(state_path)
    meta = st["meta"]
    R = int(res or meta["res"])
    sc = R / float(meta["res"])
    fx, fy, cx, cy = (float(v) * sc for v in meta["intrinsics"])
    poses = np.asarray(meta["poses"], np.float32).reshape(-1, 4, 4)[
        :n_poses]
    P = len(poses)
    data = os.path.join(out, model)
    ws = os.path.join(out, f"trial_{model}")
    for sub in ("gt_imgs", "torso_imgs", "ori_imgs"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    os.makedirs(ws, exist_ok=True)
    shutil.copyfile(state_path, os.path.join(ws, "production_state.pkl"))

    rng = np.random.default_rng(seed)
    cfg = Config()
    write = image_writer()
    frames = []
    for i, pose in enumerate(poses):
        frames.append({"img_id": i, "aud_id": i, "transform_matrix":
                       ngp_matrix_to_nerf(pose, cfg.scale,
                                          cfg.offset).tolist()})
        lms = np.stack([rng.uniform(0.3 * R, 0.7 * R, 68),
                        rng.uniform(0.3 * R, 0.7 * R, 68)], axis=-1)
        np.savetxt(os.path.join(data, "ori_imgs", f"{i}.lms"), lms)
        if write is not None:
            write(os.path.join(data, "gt_imgs", f"{i}.jpg"),
                  rng.integers(0, 256, (R, R, 3), dtype=np.uint8))
            torso = np.zeros((R, R, 4), np.uint8)
            torso[2 * R // 3:, :, :3] = rng.integers(60, 200, 3)
            torso[2 * R // 3:, :, 3] = 255
            write(os.path.join(data, "torso_imgs", f"{i}.png"), torso)
    if write is not None:
        # a smooth seeded gradient: what a background plate looks like
        y, x = np.meshgrid(np.linspace(0, 1, R), np.linspace(0, 1, R),
                           indexing="ij")
        c0, c1 = rng.uniform(40, 215, (2, 3))
        bg = c0 * (1 - 0.5 * (x + y))[..., None] + c1 * (
            0.5 * (x + y))[..., None]
        write(os.path.join(data, "bc.jpg"), bg.astype(np.uint8))
    else:
        # the provider needs each frame's gt image to exist, never reads
        # it while serving
        for i in range(P):
            open(os.path.join(data, "gt_imgs", f"{i}.jpg"), "wb").close()
    # the val split (the CLI's training evals) holds the same frames
    for split in ("train", "val"):
        with open(os.path.join(data, f"transforms_{split}.json"), "w") as f:
            json.dump({"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "h": R,
                       "w": R, "frames": frames}, f)
    with open(os.path.join(data, "au.csv"), "w") as f:
        f.write("frame, AU45_r\n")
        for i, v in enumerate(rng.uniform(0.0, 1.0, P)):
            f.write(f"{i}, {v:.6f}\n")
    np.save(os.path.join(data, "aud_ds.npy"), rng.standard_normal(
        (P, 16, int(meta["audio_dim"]))).astype(np.float32))
    return {"data": data, "workspace": ws, "poses": poses,
            "bg_img": "" if write is not None else "white",
            "codec": write is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--state", default=_STATE)
    ap.add_argument("--model", default="identity")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--poses", type=int, default=None,
                    help="the state's first N poses (default all)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    got = write_identity(args.out, args.state, args.model, args.res,
                         args.poses, args.seed)
    print(f"dataset {got['data']}, workspace {got['workspace']}, "
          f"background {'bc.jpg' if got['codec'] else 'white (no codec)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
