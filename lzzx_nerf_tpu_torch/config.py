"""The framework's one config dataclass (the port's copy of
lzzx_nerf_tpu/config.py: the same fields, defaults and JSON round trip).

The serving session and the HTTP server read it. Fields that select a
path the port has no code for make the session raise when it loads a
model (serving/session.py), never fall back to another path."""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Tuple


@dataclass
class Config:
    # paths / workspace
    path: str = "data/obama"
    workspace: str = "workspace"
    seed: int = 0
    ckpt: str = "latest"
    head_ckpt: str = ""

    # mode
    test: bool = False
    test_train: bool = False
    save_mesh: bool = False
    mesh_resolution: int = 256
    mesh_threshold: float = 10.0
    data_range: Tuple[int, int] = (0, -1)

    # training schedule
    iters: int = 200_000
    lr: float = 1e-2          # grid-table learning rate
    lr_net: float = 1e-3      # MLP learning rate
    num_rays: int = 4096 * 16
    max_steps: int = 16       # max samples kept per ray
    num_steps: int = 16
    upsample_steps: int = 0
    update_extra_interval: int = 16
    max_ray_batch: int = 4096
    warmup_step: int = 10_000

    # losses
    amb_aud_loss: bool = True
    amb_eye_loss: bool = True
    unc_loss: bool = True
    lambda_amb: float = 1e-4

    fp16: bool = True

    # background / eyes
    bg_img: str = ""          # "" = <path>/bc.jpg, "white", "black" or a file
    fbg: bool = False
    exp_eye: bool = True
    fix_eye: float = -1.0     # >= 0: every frame renders this eye value
    smooth_eye: bool = False

    torso_shrink: float = 0.8

    # dataset
    color_space: str = "srgb"
    preload: int = 0
    bound: float = 1.0
    scale: float = 4.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dt_gamma: float = 1.0 / 256
    min_near: float = 0.05
    density_thresh: float = 10.0
    density_thresh_torso: float = 0.01
    patch_size: int = 1

    init_lips: bool = False
    finetune_lips: bool = False
    allow_rand_lpips: bool = False
    smooth_lips: bool = False
    lips_crop: int = 64

    torso: bool = False

    # audio
    att: int = 2              # audio attention mode: 0 off, 1 left, 2 bi
    aud: str = ""
    emb: bool = False
    asr_model: str = "hubert"  # deepspeech(29) | esperanto(44) | hubert(1024)

    # individual codes
    ind_dim: int = 4
    ind_num: int = 10_000
    ind_dim_torso: int = 8

    amb_dim: int = 2
    part: bool = False
    part2: bool = False

    # camera
    train_camera: bool = False
    smooth_path: bool = False
    smooth_path_window: int = 7

    # live ASR
    asr: bool = False
    asr_wav: str = ""
    asr_play: bool = False
    asr_save_feats: bool = False
    fps: int = 50
    l: int = 10
    m: int = 50
    r: int = 10

    # serving
    gui: bool = False
    W: int = 450
    H: int = 450
    radius: float = 3.35
    fovy: float = 21.24
    max_spp: int = 1
    face_optimize: bool = False

    # field encoder: "dense" (corner-packed triplane) or "hash"
    encoder: str = "dense"

    # renderer internals
    grid_size: int = 128
    density_scale: float = 1.0
    T_thresh: float = 1e-4

    # training-ray compaction and the staged training eval
    train_budget_frac: float = 0.75
    train_compact_warmup: int = 1000
    train_stage_split: int = 0
    train_stage2_frac: float = 0.34
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    data_parallel: int = 0
    ema_decay: float = 0.95
    ema_update_interval: int = 1000
    # serve from the EMA weights
    use_ema: bool = True
    # serving: samples per ray (0 = max_steps)
    infer_samples: int = 16
    # window candidates per compacted ray; 0 = measured over the poses
    infer_window_candidates: int = 0
    # staged eval: samples [0, split) for every ray, [split, S) only for
    # rays still transmissive at the split (0 = one pass)
    infer_stage_split: int = 8
    infer_stage2_frac: float = 0.375  # stage-2 ray budget / ray budget
    # post-march field-eval ray budget as a fraction of the ray budget
    # (0 = off): blocks with no marched sample skip the field eval
    infer_eval_frac: float = 0.0
    # stage-1 sample compaction (0 = off)
    infer_sample_frac: float = 0.0
    # block-path march: 2 = block-shared 5x5-neighbourhood bitmask march
    infer_march_group: int = 2
    infer_march_variant: str = "nb5w"
    # occupancy prepass before the block march
    infer_march_prepass: bool = True
    # short/long two-bucket block march (needs the prepass)
    infer_march_bucket: bool = True
    # frames per dispatch; adds chunk - 1 frames of stream latency
    infer_chunk: int = 8
    # frame-parallel serving over N devices (0/1 = one device)
    infer_data_parallel: int = 0
    # active-ray budget as a fraction of the frame; a frame that outgrows
    # it rebuilds the plan at the next chunk boundary
    budget_frac: float = 0.375
    # bf16 baked triplane tables at inference
    infer_table_bf16: bool = True
    # 2 = window analysis per 2x2 pixel block, 1 = per ray
    infer_block: int = 2
    # serving field evaluation: -1/1 folded weights, 2 the fused kernel,
    # 0 the plain module
    fused_field: int = -1
    eval_interval: int = 0
    eval_frames: int = 0
    max_keep_ckpt: int = 2

    @property
    def audio_in_dim(self) -> int:
        if "esperanto" in self.asr_model:
            return 44
        if "deepspeech" in self.asr_model:
            return 29
        if "hubert" in self.asr_model:
            return 1024
        return 32

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    def aabb(self) -> Tuple[float, float, float, float, float, float]:
        b = self.bound
        return (-b, -b / 2, -b, b, b / 2, b)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self, indent=2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        for k in ("data_range", "offset", "mesh_shape", "mesh_axis_names"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return Config(**d)
