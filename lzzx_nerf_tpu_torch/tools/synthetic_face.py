"""A seeded stand-in for the files preprocessing needs and the repository
does not ship: Basel-Face-Model-shaped 3DMM assets and a portrait clip
rendered from known tracking parameters.

- write_bfm_assets: 3DMM_info.npy + keys_info.npy at the BFM's published
  widths (scripts/convert_bfm.py's layout): a rows x cols grid "face"
  (175 x 198 = 34,650 vertices, the tracker's BFM crop) with its
  triangles, identity / expression / texture bases of 100 / 79 / 100
  components, 68 key vertices and 8 x K contour candidate sets. Bases and
  means are in the BFM's units (the loader divides geometry by 1e5).
- write_frames: ori_imgs/<i>.jpg rendered with the port's point-splat
  renderer (preprocess.face_tracking.render_photometric) from seeded
  ground-truth parameters over a grey background with a green neck and a
  blue torso, <i>.lms (the 68 projected landmarks plus seeded noise, the
  face_alignment output format), a TorchScript parser that labels pixels by
  their dominant colour (CelebAMask-HQ classes: skin, neck, cloth,
  background), and the dataset files tasks 1-3 and OpenFace would write:
  aud_ds.npy (seeded 29-wide features) and au.csv (seeded blinks).

Every output is a stand-in: none of it is a real face, voice or model.

    python -m lzzx_nerf_tpu_torch.tools.synthetic_face --out DIR \\
        [--frames 100] [--res 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

# the BFM crop the tracker uses: 34,650 vertices
ROWS, COLS = 175, 198


def write_bfm_assets(out: str, rows: int = ROWS, cols: int = COLS,
                     id_dim: int = 100, exp_dim: int = 79,
                     tex_dim: int = 100, contour: int = 15,
                     seed: int = 0) -> Dict:
    """Write out/3DMM_info.npy and out/keys_info.npy; returns their
    sizes."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    xs, ys = np.meshgrid(np.linspace(-0.6, 0.6, cols),
                         np.linspace(-0.75, 0.75, rows), indexing="xy")
    zs = 1.2 * (1 - 0.8 * (xs ** 2 + ys ** 2))           # toward the camera
    mu = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    n = mu.shape[0]
    tris = []
    for r in range(rows - 1):
        a = r * cols + np.arange(cols - 1)
        b, c, d = a + 1, a + cols, a + cols + 1
        tris.append(np.stack([a, b, c], -1))
        tris.append(np.stack([b, d, c], -1))               # +z winding
    tris = np.concatenate(tris).astype(np.int64)
    skin = np.stack([rng.uniform(170, 210, n), rng.uniform(70, 110, n),
                     rng.uniform(60, 100, n)], -1)
    # smooth deformation bases: each component a random mix of the 16
    # lowest cosine modes over the grid, per coordinate
    modes = np.stack([np.cos(i * np.pi * (xs.ravel() + 1) / 2)
                      * np.cos(j * np.pi * (ys.ravel() + 1) / 2)
                      for i in range(4) for j in range(4)], -1)   # [n, 16]

    def basis(k):
        coef = rng.standard_normal((k, 16, 3)) / 4.0
        return np.einsum("nm,kmc->knc", modes, coef).reshape(k, 3 * n)

    info = {
        # geometry in the BFM's units: the loader divides by 1e5
        "mu_shape": (mu * 1e5).reshape(-1).astype(np.float32),
        "mu_exp": np.zeros(3 * n, np.float32),
        "b_shape": (basis(id_dim) * 1e2).astype(np.float32),
        "b_exp": (basis(exp_dim) * 1e2).astype(np.float32),
        "sig_shape": np.ones(id_dim, np.float32),
        "sig_exp": np.ones(exp_dim, np.float32),
        "b_tex": (rng.standard_normal((tex_dim, 3 * n)) * 4.0
                  ).astype(np.float32),
        "mu_tex": skin.reshape(-1).astype(np.float32),
        "sig_tex": np.ones(tex_dim, np.float32),
        "tris": tris,
    }
    # key points on the front of the face; each contour landmark's
    # candidates run along one grid row from the face's edge inward, as
    # the BFM's silhouette candidates do (near-colinear, so the extreme-x
    # snap is stable)
    front = np.flatnonzero((np.abs(mu[:, 0]) < 0.45)
                           & (np.abs(mu[:, 1]) < 0.6))
    jaw = np.linspace(0.1 * (rows - 1), 0.6 * (rows - 1), 8).round()
    jaw = jaw.astype(np.int64)[:, None] * cols
    keys = {"keyinds": rng.choice(front, 68, replace=False),
            "left_contour": jaw + np.arange(contour)[None],
            "right_contour": jaw + cols - 1 - np.arange(contour)[None]}
    np.save(os.path.join(out, "3DMM_info.npy"), info)
    np.save(os.path.join(out, "keys_info.npy"), keys)
    return {"vertices": n, "triangles": len(tris), "id": id_dim,
            "exp": exp_dim, "tex": tex_dim, "contour": contour}


def ground_truth(frames: int, id_dim: int, exp_dim: int, tex_dim: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded tracking parameters: smooth head motion about trans
    (0, 0, -7) at focal 1100 (a point of the tracker's focal grid), the
    mean identity and small expressions (as tests/test_face_tracking.py's
    case: a landmark fit cannot tell a larger face from a nearer one, and
    its identity prior pulls toward the mean)."""
    rng = np.random.default_rng(seed + 1)
    t = np.arange(frames)[:, None]
    ph = rng.uniform(0, 2 * np.pi, (1, 3))
    euler = 0.12 * np.sin(t / 9.0 + ph)
    trans = np.concatenate([0.15 * np.sin(t / 11.0 + ph[:, :2]),
                            -7.0 + 0.2 * np.sin(t / 13.0 + ph[:, 2:])], -1)
    return {"id": np.zeros((1, id_dim)),
            "exp": 0.05 * np.sin(t / 7.0 + rng.uniform(0, 6.3, (1, exp_dim))),
            "euler": euler, "trans": trans, "focal": np.float32(1100.0),
            "tex": rng.standard_normal((1, tex_dim)) * 0.5,
            "gamma": rng.uniform(-0.1, 0.1, (frames, 9, 3))}


def parser_module() -> torch.nn.Module:
    """A TorchScript parser: [1, 3, H, W] RGB in [0, 1] -> 19 class
    logits, the pixel's dominant colour deciding skin (1), neck (14) or
    cloth (16); grey is background (0)."""

    class ColourParser(torch.nn.Module):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            r, g, b = x[:, 0], x[:, 1], x[:, 2]
            logits = torch.zeros(x.shape[0], 19, x.shape[2], x.shape[3],
                                 device=x.device)
            logits[:, 0] = 0.15
            logits[:, 1] = 2 * r - g - b
            logits[:, 14] = 2 * g - r - b
            logits[:, 16] = 2 * b - r - g
            return logits

    return torch.jit.script(ColourParser())


def write_frames(base: str, model_dir: str, frames: int = 100,
                 res: int = 512, noise_px: float = 0.5, seed: int = 0,
                 device=None, chunk: int = 16) -> Dict:
    """Render the clip into base/ori_imgs and write the stand-in parser
    (base/parser.ts), aud_ds.npy and au.csv -> {"gt": ground truth,
    "ori_dir", "parser"}."""
    import cv2

    from ..preprocess.face_tracking import (Face3DMM, forward_transform,
                                            render_photometric)
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    model = Face3DMM.load(model_dir, device=dev)
    gt = ground_truth(frames, model.base_id.shape[0],
                      model.base_exp.shape[0], model.base_tex.shape[0], seed)
    ori = os.path.join(base, "ori_imgs")
    os.makedirs(ori, exist_ok=True)
    rng = np.random.default_rng(seed + 2)
    cxy = (res / 2.0, res / 2.0)
    # the plate behind the head: grey, a green neck, a blue torso
    plate = np.full((res, res, 3), 128, np.uint8)
    plate[int(0.78 * res):int(0.9 * res), int(0.4 * res):int(0.6 * res)] = \
        (40, 200, 40)
    plate[int(0.9 * res):, int(0.15 * res):int(0.85 * res)] = (40, 40, 200)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for s in range(0, frames, chunk):
        e = min(frames, s + chunk)
        p = {k: t(v[s:e]) if k in ("exp", "euler", "trans", "gamma")
             else t(v) for k, v in gt.items()}
        with torch.no_grad():
            # rendered at a quarter of the side (the tracker's photometric
            # scale: a vertex or more per pixel), then upsampled
            img, wsum = render_photometric(model, p, cxy, res, res,
                                           scale=0.25)
            idb = p["id"].expand(e - s, -1)
            lms = forward_transform(
                model.landmarks_3d(idb, p["exp"], p["euler"], p["trans"],
                                   p["focal"], cxy),
                p["euler"], p["trans"], p["focal"], cxy)[..., :2]
        img = img.clamp(0, 1).cpu().numpy()
        cover = (wsum > 0.5).to(torch.float32).cpu().numpy()
        lms = lms.cpu().numpy() + rng.normal(0, noise_px, lms.shape)
        for j in range(e - s):
            up = cv2.resize(img[j], (res, res), interpolation=cv2.INTER_LINEAR)
            inside = cv2.resize(cover[j], (res, res),
                                interpolation=cv2.INTER_LINEAR) > 0.5
            rgb = np.where(inside[..., None],
                           np.round(up * 255).astype(np.uint8), plate)
            cv2.imwrite(os.path.join(ori, f"{s + j}.jpg"), rgb[..., ::-1])
            np.savetxt(os.path.join(ori, f"{s + j}.lms"), lms[j], "%f")
    parser = os.path.join(base, "parser.ts")
    parser_module().save(parser)
    np.save(os.path.join(base, "aud_ds.npy"), rng.standard_normal(
        (frames, 16, 29)).astype(np.float32))
    with open(os.path.join(base, "au.csv"), "w") as f:
        f.write("frame, AU45_r\n")
        for i in range(frames):
            f.write(f"{i}, {1.0 + 0.5 * np.sin(i / 5.0):.6f}\n")
    return {"gt": gt, "ori_dir": ori, "parser": parser}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    sizes = write_bfm_assets(os.path.join(a.out, "3DMM"), seed=a.seed)
    base = os.path.join(a.out, "identity")
    write_frames(base, os.path.join(a.out, "3DMM"), a.frames, a.res,
                 seed=a.seed, device=a.device)
    print(f"3DMM assets {sizes} in {a.out}/3DMM; {a.frames} frames at "
          f"{a.res}² in {base}/ori_imgs; parser {base}/parser.ts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
