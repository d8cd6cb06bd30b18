"""Write the synthetic oracle (data/synthetic.py) as a dataset directory in
the layout the provider reads, so the CLI trains on it as on a
preprocessed identity:

    python3 -m lzzx_nerf_tpu_torch.tools.dataset --out DIR
        [--res 512] [--frames 32] [--val 4] [--seed 0]

transforms_train.json (every frame) and transforms_val.json (--val frames
spread over the orbit) hold the oracle's intrinsics and, per frame, the
inverse of nerf_matrix_to_ngp at the Config's scale and offset of its
pose (the provider loads the oracle's poses); gt_imgs/<id>.jpg the
oracle's frame; torso_imgs/<id>.png the shoulders plate as RGBA (its
alpha the plate's silhouette, so the provider's torso composite over the
white bc.jpg is the oracle's); ori_imgs/<id>.lms 68 landmarks on the
projected head's outline with the lips (48-59) on its lower part; au.csv
the eye state (AU45_r = 2 x eye area); aud_ds.npy the oracle's
29-wide audio features. Images go through OpenCV, the provider's codec.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import Config
from ..data.synthetic import SyntheticTalkingHead
from .identity import image_writer, ngp_matrix_to_nerf


def write_synthetic_dataset(out: str, res: int = 512, frames: int = 32,
                            val: int = 4, seed: int = 0) -> dict:
    """Write the oracle's dataset under `out`. Returns {"data", "frames",
    "val_ids", "intrinsics"}."""
    import cv2

    write = image_writer()
    ds = SyntheticTalkingHead(num_frames=frames, H=res, W=res, torso=True,
                              seed=seed)
    for sub in ("gt_imgs", "torso_imgs", "ori_imgs"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    cfg = Config()
    fx, fy, cx, cy = ds.intrinsics
    entries = []
    for i in range(frames):
        b = ds.frame(i)
        write(os.path.join(out, "gt_imgs", f"{i}.jpg"),
              np.round(b["image"] * 255).astype(np.uint8))
        plate = b["bg_torso_color"]
        alpha = np.any(plate < 1.0, axis=-1)
        rgba = np.concatenate([np.round(plate * 255),
                               alpha[..., None] * 255.0], -1)
        cv2.imwrite(os.path.join(out, "torso_imgs", f"{i}.png"),
                    rgba.astype(np.uint8)[..., [2, 1, 0, 3]])
        r = fx * ds.radius(i) / ds.cam_dist
        th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
        outline = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], -1)
        lt = np.linspace(0, 2 * np.pi, 20, endpoint=False)
        lips = np.stack([cx + 0.3 * r * np.cos(lt),
                         cy + 0.55 * r + 0.12 * r * np.sin(lt)], -1)
        # columns then rows, as the provider reads them (lms[:, 0] = col)
        np.savetxt(os.path.join(out, "ori_imgs", f"{i}.lms"),
                   np.concatenate([outline, lips]))
        entries.append({"img_id": i, "aud_id": i, "transform_matrix":
                        ngp_matrix_to_nerf(ds.pose(i), cfg.scale,
                                           cfg.offset).tolist()})
    write(os.path.join(out, "bc.jpg"), np.full((res, res, 3), 255,
                                               np.uint8))
    head = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "h": res, "w": res}
    val_ids = list(range(1, frames, max(1, frames // val)))[:val]
    with open(os.path.join(out, "transforms_train.json"), "w") as f:
        json.dump({**head, "frames": entries}, f)
    with open(os.path.join(out, "transforms_val.json"), "w") as f:
        json.dump({**head, "frames": [entries[i] for i in val_ids]}, f)
    with open(os.path.join(out, "au.csv"), "w") as f:
        f.write("frame, AU45_r\n")
        for i in range(frames):
            f.write(f"{i}, {2.0 * float(ds.eye_area[i]):.6f}\n")
    np.save(os.path.join(out, "aud_ds.npy"),
            ds.aud_features.astype(np.float32))
    return {"data": out, "frames": frames, "val_ids": val_ids,
            "intrinsics": ds.intrinsics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--val", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    got = write_synthetic_dataset(args.out, args.res, args.frames, args.val,
                                  args.seed)
    print(f"dataset {got['data']}: {got['frames']} frames, val "
          f"{got['val_ids']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
