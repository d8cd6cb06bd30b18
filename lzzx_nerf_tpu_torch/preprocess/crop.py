"""Video crop tool (the port's copy of lzzx_nerf_tpu/preprocess/crop.py;
reference data_utils/step1.py, non-interactive). Host code: ffmpeg only.

    python -m lzzx_nerf_tpu_torch.preprocess.crop --video in.mp4 \
        --x X --y Y --w W --h H [--bc cleaned.jpg]

Cuts the training region out of a raw portrait video and prepares the
streaming-composite assets:

- trainVideo.mp4              the WxH crop @25 fps (feed to the pipeline)
- crop_region.jpg             one frame's crop — clean it to a pure
                              background plate and pass it back as --bc
- readySourceVideo.mp4        the source with the background plate pasted
                              over the crop region, silent (the overlay
                              sink streams the rendered crop onto this)
- video_crop_parameter.json   {x, y, w, h} for the overlay position
- bc.jpg                      the background plate (when --bc is given)

The reference's interactive "edit the picture, then type y" step becomes a
two-pass flow: run once without --bc to get crop_region.jpg, clean it in
any editor, rerun with --bc cleaned.jpg.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional


def crop_commands(video: str, x: int, y: int, w: int, h: int,
                  bc: Optional[str] = None) -> Dict[str, List[str]]:
    """The ffmpeg command lines (pure — unit-testable without ffmpeg)."""
    base = os.path.dirname(os.path.abspath(video))
    cmds = {
        "frame": ["ffmpeg", "-y", "-loglevel", "error", "-ss", "3", "-i",
                  video, "-vframes", "1", "-vf", f"crop={w}:{h}:{x}:{y}",
                  os.path.join(base, "crop_region.jpg")],
        "train": ["ffmpeg", "-y", "-loglevel", "error", "-i", video,
                  "-vf", f"crop={w}:{h}:{x}:{y}", "-c:v", "libx264",
                  "-c:a", "aac", "-r", "25",
                  os.path.join(base, "trainVideo.mp4")],
    }
    if bc:
        cmds["ready"] = ["ffmpeg", "-y", "-loglevel", "error", "-i", video,
                         "-i", bc, "-filter_complex", f"overlay={x}:{y}",
                         "-c:v", "libx264", "-an", "-r", "25",
                         os.path.join(base, "readySourceVideo.mp4")]
    return cmds


def run_crop_tool(video: str, x: int, y: int, w: int, h: int,
                  bc: Optional[str] = None) -> str:
    if w % 2 or h % 2:
        raise ValueError("crop width/height must be even (codec macroblock "
                         "alignment, same constraint as the reference tool)")
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    base = os.path.dirname(os.path.abspath(video))
    cmds = crop_commands(video, x, y, w, h, bc)
    subprocess.run(cmds["train"], check=True)
    subprocess.run(cmds["frame"], check=True)
    with open(os.path.join(base, "video_crop_parameter.json"), "w") as f:
        json.dump({"x": x, "y": y, "w": w, "h": h}, f)
    if bc:
        subprocess.run(cmds["ready"], check=True)
        shutil.copy(bc, os.path.join(base, "bc.jpg"))
        print(f"ready: trainVideo.mp4 + readySourceVideo.mp4 + bc.jpg in "
              f"{base}")
    else:
        print(f"wrote {base}/crop_region.jpg — clean it to a pure background "
              "plate and rerun with --bc <cleaned.jpg> to produce "
              "readySourceVideo.mp4")
    return base


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video", required=True)
    ap.add_argument("--x", type=int, required=True)
    ap.add_argument("--y", type=int, required=True)
    ap.add_argument("--w", type=int, required=True)
    ap.add_argument("--h", type=int, required=True)
    ap.add_argument("--bc", default=None,
                    help="cleaned background plate (second pass)")
    a = ap.parse_args(argv)
    run_crop_tool(a.video, a.x, a.y, a.w, a.h, a.bc)


if __name__ == "__main__":
    main()
