"""Preprocessing task graph (the port of lzzx_nerf_tpu/preprocess/
process.py; reference data_utils/process.py:400-487).

Nine sequential tasks turn a 2-5 minute portrait video into the training
dataset. Tasks 1/3 shell out to ffmpeg; 4/7/8 need pretrained vision models
(semantic parser, landmark detector, 3DMM tracker) and are gated with clear
errors when their dependencies are absent — each accepts precomputed outputs
dropped into the expected directory. Tasks 5/6/9 are exact numpy ports.
The models of tasks 2, 4 and 8 (HuBERT or the CTC model, the TorchScript
parser, the tracker's fits) run on the pipeline's device: "cuda" unless
--device names another; without a GPU and without --device cpu the
pipeline raises.

    python -m lzzx_nerf_tpu_torch.preprocess.process data/<id>/<id>.mp4 \
        [--task N] [--asr hubert] [--device cpu]

Semantic parsing color code (reference face_parsing_by_m2fp/m2fp.py:36-114,
same contract as preprocess/parsing.py):
  head/hair -> blue (0,0,255 in RGB), neck -> green, torso/clothes -> red,
  background -> white. The downstream tasks read the PNGs with cv2 (BGR), so
  "head" tests channel-0==255 there.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
from typing import Optional

import numpy as np


def _ffmpeg(*args: str) -> None:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH (required for tasks 1/3)")
    subprocess.run(["ffmpeg", "-y", "-loglevel", "error", *args], check=True)


def extract_audio(video_path: str, out_wav: str, sample_rate: int = 16000) -> None:
    """Task 1 (process.py:9-19): demux + resample to 16 kHz mono wav."""
    _ffmpeg("-i", video_path, "-f", "wav", "-ar", str(sample_rate),
            "-ac", "1", out_wav)


def extract_audio_features(wav_path: str, mode: str = "hubert",
                           device=None) -> str:
    """Task 2 (process.py:22-35): save per-frame audio features next to the
    wav. hubert -> *_hu.npy [T/2, 2, 1024]; wav2vec/esperanto -> *_eo.npy.
    The model runs on `device` ("cuda" unless named)."""
    if mode == "hubert":
        from ..audio.hubert import HubertFeatureExtractor

        out = wav_path.replace(".wav", "_hu.npy")
        feats = HubertFeatureExtractor(device=device).features_from_wav(
            wav_path)
        np.save(out, feats)
        return out
    if mode in ("wav2vec", "esperanto"):
        from ..serving.asr import StreamingASR, wav_chunk_stream

        asr = StreamingASR(
            audio_dim=44,
            asr_model="cpierse/wav2vec2-large-xlsr-53-esperanto",
            save_feats=True, device=device)
        for chunk in wav_chunk_stream(wav_path):
            asr.step(chunk)
        asr.step(None)
        out = wav_path.replace(".wav", "_eo.npy")
        np.save(out, asr.unfolded_features())
        return out
    if mode == "deepspeech":
        # The reference advertises --asr_model deepspeech
        # (data_utils/process.py:29) but its snapshot does not ship the
        # TF-based extractor either (data_utils/deepspeech_features/ is
        # referenced, absent). Training/serving fully support 29-dim
        # deepspeech features (Config.asr_model, data/provider.py) —
        # bring your own <name>_ds.npy [T, 16, 29] produced by the
        # original AD-NeRF extractor.
        raise ValueError(
            "deepspeech feature EXTRACTION is not bundled (the reference "
            "snapshot lacks it too); supply <wav>_ds.npy [T, 16, 29] from "
            "the AD-NeRF deepspeech_features tool — training and serving "
            "accept it via --asr_model deepspeech")
    raise ValueError(f"unknown audio feature mode {mode}")


def extract_images(video_path: str, ori_dir: str, fps: int = 25) -> None:
    """Task 3 (process.py:39-50): dump frames at 25 fps."""
    os.makedirs(ori_dir, exist_ok=True)
    _ffmpeg("-i", video_path, "-vf", f"fps={fps}", "-qmin", "1", "-q:v", "1",
            "-start_number", "0", os.path.join(ori_dir, "%d.jpg"))


def extract_semantics(ori_dir: str, parsing_dir: str, parser=None,
                      device=None) -> None:
    """Task 4 (process.py:53-76): head/neck/torso/background segmentation
    via preprocess.parsing (TorchScript BiSeNet-style parser through
    LZZX_PARSER_TS on `device`, or ModelScope M2FP — the reference's
    backend — when installed). Color contract documented in the module
    docstring."""
    from .parsing import run_parsing

    n = run_parsing(ori_dir, parsing_dir, parser=parser, device=device)
    print(f"[INFO] parsed {n} frames -> {parsing_dir}")


def extract_background(base_dir: str, ori_dir: str, every: int = 20,
                       dist_thresh: float = 5.0) -> str:
    """Task 5 (process.py:100-154): assemble a clean background plate.

    For every `every`-th frame, compute each pixel's distance to the nearest
    foreground pixel (from the parsing mask); a pixel whose max-over-frames
    distance exceeds `dist_thresh` takes its color from the frame where it
    was farthest from any foreground; remaining holes copy their nearest
    filled pixel. Uses scipy cKDTree (the reference uses sklearn's kd-tree)."""
    import cv2
    from scipy.spatial import cKDTree

    image_paths = sorted(glob.glob(os.path.join(ori_dir, "*.jpg")))[::every]
    first = cv2.imread(image_paths[0], cv2.IMREAD_UNCHANGED)
    h, w = first.shape[:2]
    all_xys = np.mgrid[0:h, 0:w].reshape(2, -1).T

    dists = []
    for p in image_paths:
        parse = cv2.imread(p.replace("ori_imgs", "parsing")
                           .replace(".jpg", ".png"))
        bg = ((parse[..., 0] == 255) & (parse[..., 1] == 255)
              & (parse[..., 2] == 255))
        fg_xys = np.stack(np.nonzero(~bg)).T
        tree = cKDTree(fg_xys)
        d, _ = tree.query(all_xys, k=1)
        dists.append(d)
    dists = np.stack(dists)                       # [F, h*w]
    max_dist = dists.max(0)
    max_id = dists.argmax(0)

    bc_pixs = max_dist > dist_thresh
    bc_ids = max_id[bc_pixs]
    imgs = np.stack([cv2.imread(p) for p in image_paths]).reshape(
        len(image_paths), -1, 3)
    bc_img = np.zeros((h * w, 3), np.uint8)
    bc_img[np.nonzero(bc_pixs)] = imgs[bc_ids, np.nonzero(bc_pixs)[0]]
    bc_img = bc_img.reshape(h, w, 3)

    # fill holes from nearest background pixel
    md = max_dist.reshape(h, w)
    holes = np.stack(np.nonzero(md <= dist_thresh)).T
    filled = np.stack(np.nonzero(md > dist_thresh)).T
    if len(holes) and len(filled):
        tree = cKDTree(filled)
        _, idx = tree.query(holes, k=1)
        src = filled[idx]
        bc_img[holes[:, 0], holes[:, 1]] = bc_img[src[:, 0], src[:, 1]]

    out = os.path.join(base_dir, "bc.jpg")
    cv2.imwrite(out, bc_img)
    return out


def _vertical_inpaint(image, gt_image, part_mask, head_part, L,
                      push_down: int = 0):
    """Shared vertical in-painting: from each column's topmost `part` pixel
    (whose upper neighbour is head), paint L pixels upward with 0.98^i
    darkening (process.py:196-262). Returns the painted mask."""
    coords = np.stack(np.nonzero(part_mask), axis=-1)
    if len(coords) == 0:
        return np.zeros_like(part_mask)
    inds = np.lexsort((coords[:, 0], coords[:, 1]))
    coords = coords[inds]
    _, uid, ucnt = np.unique(coords[:, 1], return_index=True,
                             return_counts=True)
    top = coords[uid]
    up = top - np.array([1, 0])
    ok = head_part[tuple(up.T)]
    painted = np.zeros_like(part_mask)
    if not ok.any():
        return painted
    top = top[ok]
    if push_down:
        offset_down = np.minimum(ucnt[ok] - 1, push_down)
        top = top + np.stack([offset_down, np.zeros_like(offset_down)], -1)
    colors = gt_image[tuple(top.T)]
    coords_l = top[None].repeat(L, 0)
    offsets = np.stack([-np.arange(L), np.zeros(L, np.int64)], -1)[:, None]
    coords_l = (coords_l + offsets).reshape(-1, 2)
    coords_l[:, 0] = np.clip(coords_l[:, 0], 0, image.shape[0] - 1)
    darken = 0.98 ** np.arange(L).reshape(L, 1, 1)
    colors_l = (colors[None].repeat(L, 0) * darken).reshape(-1, 3)
    image[tuple(coords_l.T)] = colors_l
    painted[tuple(coords_l.T)] = True
    return painted


def extract_torso_and_gt(base_dir: str, ori_dir: str) -> None:
    """Task 6 (process.py:157-285): build gt (bg-swapped) images and RGBA
    torso plates with vertical neck/torso in-painting."""
    import cv2
    from scipy.ndimage import binary_dilation

    bg_image = cv2.imread(os.path.join(base_dir, "bc.jpg"),
                          cv2.IMREAD_UNCHANGED)
    for image_path in sorted(glob.glob(os.path.join(ori_dir, "*.jpg"))):
        ori = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
        seg = cv2.imread(image_path.replace("ori_imgs", "parsing")
                         .replace(".jpg", ".png"))
        head = (seg[..., 0] == 255) & (seg[..., 1] == 0) & (seg[..., 2] == 0)
        neck = (seg[..., 0] == 0) & (seg[..., 1] == 255) & (seg[..., 2] == 0)
        torso = (seg[..., 0] == 0) & (seg[..., 1] == 0) & (seg[..., 2] == 255)
        bg = (seg[..., 0] == 255) & (seg[..., 1] == 255) & (seg[..., 2] == 255)

        gt = ori.copy()
        gt[bg] = bg_image[bg]
        cv2.imwrite(image_path.replace("ori_imgs", "gt_imgs"), gt)

        torso_img = gt.copy()
        torso_img[head] = bg_image[head]
        alpha = 255 * np.ones((*gt.shape[:2], 1), np.uint8)

        painted_torso = _vertical_inpaint(torso_img, gt, torso, head, L=9)

        neck_d = binary_dilation(
            neck, structure=np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], bool),
            iterations=3)
        painted_neck = _vertical_inpaint(torso_img, gt, neck_d, head,
                                         L=48 + 4 + 1, push_down=4)

        # blur painted region to hide vertical streaks (process.py:264-270)
        blur = cv2.GaussianBlur(torso_img, (5, 5), cv2.BORDER_DEFAULT)
        torso_img[painted_neck] = blur[painted_neck]

        mask = neck_d | torso | painted_neck | painted_torso
        torso_img[~mask] = 0
        alpha[~mask] = 0
        cv2.imwrite(
            image_path.replace("ori_imgs", "torso_imgs").replace(".jpg", ".png"),
            np.concatenate([torso_img, alpha], axis=-1))


def extract_landmarks(ori_dir: str) -> None:
    """Task 7 (process.py:79-97): 68-point landmarks -> .lms files."""
    try:
        import face_alignment
    except ImportError:
        raise RuntimeError(
            "face_alignment not installed; generate .lms files elsewhere and "
            f"drop them into {ori_dir}")
    import cv2

    fa = face_alignment.FaceAlignment(face_alignment.LandmarksType.TWO_D,
                                      flip_input=False)
    for p in sorted(glob.glob(os.path.join(ori_dir, "*.jpg"))):
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        lms = fa.get_landmarks(img)
        if lms:
            np.savetxt(p.replace(".jpg", ".lms"), lms[-1], "%f")


def face_tracking(ori_dir: str, base_dir: str,
                  modelpath: Optional[str] = None, device=None,
                  log=None) -> None:
    """Task 8 (process.py:288-311 + face_tracking/): 3DMM head-pose fit via
    preprocess.face_tracking.track_video (all four stages: focal search,
    coarse fit, photometric light/texture when the BFM textures are present,
    fine fit). Gated ONLY on the BFM assets: point LZZX_BFM_DIR (or
    `modelpath`) at a directory holding 3DMM_info.npy + keys_info.npy
    (convert with scripts/convert_bfm.py; the BFM itself is not
    redistributable and is gitignored in the reference snapshot too).
    The fits run on `device`; log(stage, seconds) after each stage."""
    from .face_tracking import track_video

    modelpath = modelpath or os.environ.get("LZZX_BFM_DIR") or os.path.join(
        base_dir, "..", "3DMM")
    track_video(ori_dir, base_dir, modelpath, device=device, log=log)


def save_transforms(base_dir: str, ori_dir: str,
                    track_params: Optional[dict] = None) -> None:
    """Task 9 (process.py:314-397): tracked euler/trans -> inverse c2w poses,
    10/11 train/val split, transforms_{train,val}.json.

    track_params: {'focal': [..], 'euler': [N,3], 'trans': [N,3]} (the
    contents of track_params.pt; loaded from disk when not passed)."""
    import cv2

    image_paths = glob.glob(os.path.join(ori_dir, "*.jpg"))
    first = cv2.imread(image_paths[0], cv2.IMREAD_UNCHANGED)
    h, w = first.shape[:2]

    if track_params is None:
        npz = os.path.join(base_dir, "track_params.npz")
        if os.path.exists(npz):
            d = np.load(npz)
            track_params = {k: np.asarray(d[k]) for k in d.files}
        else:
            import torch

            d = torch.load(os.path.join(base_dir, "track_params.pt"),
                           map_location="cpu")
            track_params = {k: v.numpy() if torch.is_tensor(v)
                            else np.asarray(v) for k, v in d.items()}

    focal = np.asarray(track_params["focal"]).reshape(-1)
    euler = np.asarray(track_params["euler"], np.float32)        # [N, 3]
    trans = np.asarray(track_params["trans"], np.float32) / 10.0  # [N, 3]
    n = euler.shape[0]

    # Params row i belongs to the i-th frame that HAS landmarks (the tracker
    # loads sorted *.lms only — face_tracking.track_video / reference
    # data_loader.py:6-16). The reference writes img_id=i densely
    # (process.py:382-384), which misaligns every pose after a frame whose
    # detection failed and then crashes its provider on the missing .lms; we
    # write the true frame id instead.
    valid_ids = sorted(
        int(os.path.basename(p).split(".")[0])
        for p in glob.glob(os.path.join(ori_dir, "*.lms")))
    if len(valid_ids) < n:
        raise RuntimeError(
            f"track_params has {n} rows but only {len(valid_ids)} .lms files "
            f"exist in {ori_dir} — rerun task 7/8 on a consistent frame set")
    valid_ids = valid_ids[:n]

    # tracker rotation convention: shared with the fit that produced the
    # params (preprocess.face_tracking.euler2rot), computed in float32 on
    # the host and only then widened, as the JAX package does
    import torch

    from .face_tracking import euler2rot

    rot = euler2rot(torch.from_numpy(euler)).numpy().astype(np.float64)
    rot_inv = rot.transpose(0, 2, 1)
    trans_inv = -(rot_inv @ trans[..., None].astype(np.float64))[..., 0]

    split = int(n * 10 / 11)
    for name, ids in (("train", range(0, split)), ("val", range(split, n))):
        out = {"focal_len": float(focal[0]), "cx": w / 2.0, "cy": h / 2.0,
               "frames": []}
        for i in ids:
            pose = np.eye(4, dtype=np.float64)
            pose[:3, :3] = rot_inv[i]
            pose[:3, 3] = trans_inv[i]
            out["frames"].append({"img_id": valid_ids[i],
                                  "aud_id": valid_ids[i],
                                  "transform_matrix": pose.tolist()})
        with open(os.path.join(base_dir, f"transforms_{name}.json"), "w") as f:
            json.dump(out, f, indent=2)


def run_pipeline(video_path: str, task: int = -1, asr: str = "hubert",
                 device=None, log=print) -> None:
    """The pipeline (process.py:400-487). The models of tasks 2, 4 and 8
    run on `device` ("cuda" unless named; raises without a GPU). log: a
    line per task with its seconds."""
    import time

    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    base_dir = os.path.dirname(video_path)
    wav_path = os.path.join(base_dir, "aud.wav")
    ori_dir = os.path.join(base_dir, "ori_imgs")
    for d in ("ori_imgs", "parsing", "gt_imgs", "torso_imgs"):
        os.makedirs(os.path.join(base_dir, d), exist_ok=True)

    tasks = {
        1: lambda: extract_audio(video_path, wav_path),
        2: lambda: extract_audio_features(wav_path, asr, device=dev),
        3: lambda: extract_images(video_path, ori_dir),
        4: lambda: extract_semantics(ori_dir,
                                     os.path.join(base_dir, "parsing"),
                                     device=dev),
        5: lambda: extract_background(base_dir, ori_dir),
        6: lambda: extract_torso_and_gt(base_dir, ori_dir),
        7: lambda: extract_landmarks(ori_dir),
        8: lambda: face_tracking(
            ori_dir, base_dir, device=dev,
            log=lambda name, s: log(f"[task 8] {name}: {s:.2f} s")),
        9: lambda: save_transforms(base_dir, ori_dir),
    }
    for n, run in tasks.items():
        if task in (-1, n):
            t0 = time.perf_counter()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            run()
            peak = ""
            if dev.type == "cuda":
                peak = (f", peak device memory "
                        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f}"
                        " MiB")
            log(f"[task {n}] done in {time.perf_counter() - t0:.2f} s "
                f"on {dev}{peak}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("path", type=str)
    ap.add_argument("--task", type=int, default=-1)
    ap.add_argument("--asr", type=str, default="hubert")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain PyTorch path")
    a = ap.parse_args(argv)
    run_pipeline(a.path, a.task, a.asr, device=a.device)


if __name__ == "__main__":
    main()
