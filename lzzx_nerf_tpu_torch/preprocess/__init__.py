"""Offline preprocessing: video -> per-frame NeRF dataset (the port of
lzzx_nerf_tpu/preprocess; reference data_utils/process.py, its nine tasks)."""

from .process import (extract_audio, extract_images, extract_background,
                      extract_semantics, extract_torso_and_gt,
                      save_transforms, run_pipeline)
