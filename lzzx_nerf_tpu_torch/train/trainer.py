"""The training steps and the eval render (port of
lzzx_nerf_tpu/train/trainer.py: TrainState, make_train_step,
make_eval_step, make_torso_train_step).

A head step: random rays of one frame (or, for the lips finetune, the
fixed lips_pad² crop at the frame's lips rect), the audio code, the field
through the full-path march (render_rays) or the window-compacted one
(render_rays_train_compact; never under the lips finetune), the head loss
stack, LPIPS on the lips crop, the every-16-steps jitter regulariser (off
under the lips finetune), backward, the optimizer (non-finite steps
skipped on the device) and the periodic EMA. A torso step: random pixels,
the torso pass over the frame's background (run_torso), the torso loss,
the optimizer and the EMA; the head is not touched. A step's random draws
come from an explicit generator on the step's device, or are passed in
(`draws`) — the parity tests pass the JAX package's threefry draws. A step
reads nothing back to the host: its metrics are device tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from torch import nn

from ..models.nerf import NeRFField, TorsoField
from ..render.renderer import (render_rays, render_rays_train_compact,
                               run_torso)
from ..render.state import OccupancyState, RenderSettings
from ..utils.pose import camera_refinement
from ..utils.rays import get_bg_coords, get_rays
from . import lpips as lpips_mod
from .losses import head_losses, torso_losses
from .optim import HeadOptimizer, lr_decay_rate


@dataclass
class TrainState:
    """A stage's module (the head field or the torso), its optimizer, the
    parameters' EMA and the step count."""

    field: nn.Module
    opt: HeadOptimizer
    ema: Dict[str, torch.Tensor]
    step: int = 0

    @classmethod
    def create(cls, field: nn.Module, opt: HeadOptimizer) -> "TrainState":
        return cls(field=field, opt=opt,
                   ema={n: p.detach().clone()
                        for n, p in field.named_parameters()})

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        for n, p in self.field.named_parameters():
            e = self.ema[n]
            e.copy_(decay * e + (1 - decay) * p)


def _draw(dev, draws: Mapping, gen: Optional[torch.Generator], name: str,
          make):
    """draws[name] on `dev` when given, else make(gen)."""
    got = draws.get(name)
    if got is not None:
        return got.to(dev)
    if gen is None:
        raise ValueError(f"the step needs a generator for {name!r}")
    return make(gen)


def _masked_mse(a, b, w):
    w = w.to(torch.float32)
    return torch.sum(((a - b) ** 2) * w) / torch.clamp(torch.sum(w), min=1.0)


def jitter_regulariser(field: NeRFField, pts: torch.Tensor,
                       dirs: torch.Tensor, mask: torch.Tensor,
                       enc_a: torch.Tensor, c: Optional[torch.Tensor],
                       eye: torch.Tensor, delta: torch.Tensor,
                       packed: Dict[str, torch.Tensor], *,
                       unc_loss: bool = True, amb_aud_loss: bool = True,
                       amb_eye_loss: bool = True) -> torch.Tensor:
    """The every-16-steps regulariser: masked MSEs of the uncertainty and
    ambient outputs at the jittered samples pts + delta against their
    detached values at pts, with the audio and individual codes detached
    (reference TrainerUtil.py:346-365, via the JAX package's step)."""
    ea = enc_a.detach()
    cc = c.detach() if c is not None else None
    with torch.no_grad():
        raw = field(pts, dirs, ea, cc, eye, compute_uncertainty=unc_loss,
                    packed=packed)
    per = field(pts + delta, dirs, ea, cc, eye,
                compute_uncertainty=unc_loss, packed=packed)
    reg = pts.new_zeros(())
    if unc_loss:
        reg = reg + _masked_mse(raw.uncertainty, per.uncertainty, mask)
    if amb_aud_loss:
        reg = reg + _masked_mse(raw.ambient_aud, per.ambient_aud, mask)
    if amb_eye_loss:
        reg = reg + _masked_mse(raw.ambient_eye, per.ambient_eye, mask)
    return reg


def _f32_ratio(a: int, b: int) -> float:
    """a / b rounded like the JAX package's float32 division."""
    return float(np.float32(a) / np.float32(b))


def make_train_step(field: NeRFField, settings: RenderSettings, *, H: int,
                    W: int, intrinsics: Tuple[float, float, float, float],
                    num_rays: int, iters: int, patch_size: int = 1,
                    unc_loss: bool = True, amb_aud_loss: bool = True,
                    amb_eye_loss: bool = True, lambda_amb: float = 1e-4,
                    ind_dim: int = 4, ema_decay: float = 0.95,
                    ema_interval: int = 1000,
                    update_extra_interval: int = 16,
                    lpips_params: Optional[Mapping[str, torch.Tensor]] = None,
                    finetune_lips: bool = False, lips_pad: int = 32,
                    train_camera: bool = False, data_parallel: bool = False,
                    train_budget: int = 0, train_stage_split: int = 0):
    """Returns step(state, occ, batch, generator=None, draws=None) ->
    metrics. train_budget > 0 selects the compacted step (not under the
    lips finetune). finetune_lips: rays on the lips_pad² crop at
    batch["rect_origin"], no uncertainty terms, no regulariser, and
    0.01 x LPIPS (lpips_params, on the card's device) of the crop.

    batch: image [H, W, 3], bg_color [H, W, 3], face_mask [H, W] bool,
    pose [4, 4], auds [8, 16, C], eye [1], index (int), and for the lips
    finetune rect_origin [2] int (row, col), on the step's device. draws:
    tensors that replace the generator's draws (any subset; the rest come
    from the generator), uniform in [0, 1) unless said otherwise: "inds"
    [N] int pixel indices in [0, H*W) (not drawn under the lips finetune);
    "noise" [N], the march lattice jitter; "eye_jitter" (eye's shape), the
    blink jitter (u - 0.5) / 10; "reg_delta" [M, 3] over the step's M
    samples, the regulariser's jitter (u * 2 - 1) * 1e-3."""
    later = {"patch_size > 1": (patch_size > 1, 5),
             "data_parallel": (data_parallel, 7),
             "train_stage_split": (train_stage_split > 0, 5)}
    for what, (on, item) in later.items():
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP Queue 1 item {item})")
    if train_camera and not hasattr(field, "camera_dR"):
        raise ValueError("train_camera needs a field built with "
                         "camera_frames > 0")
    dev = next(field.parameters()).device
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    S = settings.max_steps
    use_compact = train_budget > 0 and not finetune_lips
    use_lpips = finetune_lips and lpips_params is not None
    lips_ar = torch.arange(lips_pad, device=dev)
    decay_rate = np.float32(lr_decay_rate(finetune_lips))

    def step_fn(state: TrainState, occ: OccupancyState, batch: Mapping,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Mapping] = None) -> Dict:
        draws = draws or {}
        step = state.step
        step_factor = min(_f32_ratio(step, iters), 1.0)
        if finetune_lips:
            # the fixed-size crop at the lips rect's origin (row, col)
            o = batch["rect_origin"].to(dev)
            inds = ((o[0] + lips_ar)[:, None] * W
                    + (o[1] + lips_ar)[None, :]).reshape(-1)
        else:
            inds = _draw(dev, draws, generator, "inds",
                         lambda g: torch.randint(
                             0, H * W, (min(num_rays, H * W),), generator=g,
                             device=dev))
        rays = get_rays(batch["pose"][None], intrinsics, H, W, inds=inds)
        rays_o, rays_d = rays["rays_o"][0], rays["rays_d"][0]
        if train_camera:
            # the frame's learned pose refinement, trained with the step
            dR, dT = camera_refinement(field.camera_dR, field.camera_dT,
                                       batch["index"])
            rays_o = rays_o + dT
            rays_d = rays_d @ dR
        gt = batch["image"].reshape(-1, 3).index_select(0, inds)
        face = batch["face_mask"].reshape(-1).index_select(0, inds)
        bg = batch["bg_color"].reshape(-1, 3).index_select(0, inds)
        N = gt.shape[0]
        noise = _draw(dev, draws, generator, "noise",
                      lambda g: torch.rand((N,), generator=g, device=dev))

        state.opt.zero_grad()
        enc_a = field.encode_audio_train(batch["auds"])
        c = field.individual_codes[batch["index"]] if ind_dim > 0 else None
        u = _draw(dev, draws, generator, "eye_jitter",
                  lambda g: torch.rand(batch["eye"].shape, generator=g,
                                       device=dev))
        eye = batch["eye"] + (u - 0.5) / 10
        tables = field.bake_train_tables()

        def field_fn(pts, dirs):
            return field(pts, dirs, enc_a, c, eye,
                         compute_uncertainty=unc_loss, packed=tables)

        ray_weight = None
        if use_compact:
            res = render_rays_train_compact(
                field_fn, settings, occ, rays_o, rays_d, bg, train_budget,
                noise=noise, aabb=aabb)
            ray_weight = res["ray_weight"]
        else:
            res = render_rays(field_fn, settings, occ, rays_o, rays_d, bg,
                              noise=noise, training=True, aabb=aabb)
        loss = head_losses(res, res["image"], gt, face, step_factor,
                           unc_loss=unc_loss, amb_aud_loss=amb_aud_loss,
                           amb_eye_loss=amb_eye_loss, lambda_amb=lambda_amb,
                           max_steps=S, finetune_lips_active=finetune_lips,
                           ray_weight=ray_weight)
        if use_lpips:
            shape = (1, lips_pad, lips_pad, 3)
            loss = loss + 0.01 * torch.mean(lpips_mod.lpips(
                lpips_params, res["image"].reshape(shape) * 2 - 1,
                gt.reshape(shape) * 2 - 1))

        if not finetune_lips and step % update_extra_interval == 0:
            pts, d_s, mask = res["rays"]
            u = _draw(dev, draws, generator, "reg_delta",
                      lambda g: torch.rand(pts.shape, generator=g,
                                           device=dev))
            reg = jitter_regulariser(
                field, pts, d_s, mask, enc_a, c, eye, (u * 2 - 1) * 1e-3,
                tables, unc_loss=unc_loss, amb_aud_loss=amb_aud_loss,
                amb_eye_loss=amb_eye_loss)
            loss = loss + step_factor * 1e-5 * reg

        loss.backward()
        state.opt.step()
        state.step = new_step = step + 1
        if new_step % ema_interval == 0:
            # decay 0.95 once per ema_interval steps is the reference's own
            # schedule (torch-ema gated on the step), not a bug
            state.update_ema(ema_decay)

        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                "mse": torch.mean((res["image"] - gt) ** 2),
                "weights_sum": torch.mean(res["weights_sum"]),
                "lr_factor": float(decay_rate ** np.float32(
                    _f32_ratio(new_step, iters))),
                "grad_notfinite": state.opt.total_notfinite,
            }
            if ray_weight is not None:
                metrics["n_active"] = res["n_active"]
                metrics["n_active_over"] = res["n_active"] - train_budget
        return metrics

    return step_fn


@contextlib.contextmanager
def _params_swapped(field: NeRFField, values: Mapping[str, torch.Tensor]):
    """Run with the field's parameters set to `values`, then put them
    back."""
    saved = {n: p.detach().clone() for n, p in field.named_parameters()}
    with torch.no_grad():
        for n, p in field.named_parameters():
            p.copy_(values[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in field.named_parameters():
                p.copy_(saved[n])


def make_eval_step(field: NeRFField, settings: RenderSettings, *, H: int,
                   W: int, intrinsics: Tuple[float, float, float, float],
                   ind_dim: int = 4, use_ema: bool = False):
    """Full-frame eval render (render_rays, no jitter, individual code 0):
    eval(state, occ, batch) -> dict of [H, W(, 3)] maps and the frame's
    mse ("loss")."""
    dev = next(field.parameters()).device
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def eval_fn(state: TrainState, occ: OccupancyState, batch: Mapping):
        ctx = (_params_swapped(field, state.ema) if use_ema
               else contextlib.nullcontext())
        with ctx:
            rays = get_rays(batch["pose"][None], intrinsics, H, W)
            enc_a = field.encode_audio_train(batch["auds"])
            c = field.individual_codes[0] if ind_dim > 0 else None
            eye = batch["eye"]
            tables = field.bake_train_tables()

            def field_fn(pts, dirs):
                return field(pts, dirs, enc_a, c, eye, packed=tables)

            res = render_rays(field_fn, settings, occ, rays["rays_o"][0],
                              rays["rays_d"][0],
                              batch["bg_color"].reshape(-1, 3), aabb=aabb)
        gt = batch["image"].reshape(-1, 3)
        return {"image": res["image"].reshape(H, W, 3),
                "depth": res["depth"].reshape(H, W),
                "ambient_aud": res["ambient_aud"].reshape(H, W),
                "ambient_eye": res["ambient_eye"].reshape(H, W),
                "uncertainty": res["uncertainty"].reshape(H, W),
                "loss": torch.mean((res["image"] - gt) ** 2)}

    return eval_fn


def make_torso_train_step(torso: TorsoField, settings: RenderSettings, *,
                          H: int, W: int, num_rays: int,
                          ind_dim_torso: int = 8, ema_decay: float = 0.95,
                          ema_interval: int = 1000):
    """Returns step(state, occ, batch, generator=None, draws=None) ->
    metrics for the torso stage (the head is frozen: it is not part of the
    step). num_rays uniform pixels; the target is the frame's
    torso-over-background composite batch["bg_torso_color"], the torso
    composited over batch["bg_color"]. draws["inds"] [num_rays] int
    replaces the generator's pixels."""
    dev = next(torso.parameters()).device
    bg_coords_full = get_bg_coords(H, W, device=dev)[0]

    def step_fn(state: TrainState, occ: OccupancyState, batch: Mapping,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Mapping] = None) -> Dict:
        inds = _draw(dev, draws or {}, generator, "inds",
                     lambda g: torch.randint(0, H * W, (num_rays,),
                                             generator=g, device=dev))
        bg_coords = bg_coords_full.index_select(0, inds)
        gt = batch["bg_torso_color"].reshape(-1, 3).index_select(0, inds)
        bg = batch["bg_color"].reshape(-1, 3).index_select(0, inds)

        state.opt.zero_grad()
        c = (torso.individual_codes_torso[batch["index"]]
             if ind_dim_torso > 0 else None)
        res = run_torso(torso.train_forward, settings, occ, bg_coords,
                        batch["pose"], c, bg)
        loss = torso_losses(res["torso_color"], gt, res["torso_alpha"],
                            torso.anchor_points)
        loss.backward()
        state.opt.step()
        state.step = new_step = state.step + 1
        if new_step % ema_interval == 0:
            state.update_ema(ema_decay)
        return {"loss": loss.detach(),
                "grad_notfinite": state.opt.total_notfinite}

    return step_fn


def to_device(frame: Mapping, dev) -> Dict:
    """A dataset frame (numpy arrays) as the step's batch on `dev`; the
    frame index stays a Python int."""
    return {k: (int(v) if k == "index"
                else torch.as_tensor(np.array(v), device=dev))
            for k, v in frame.items()}


def checkpoint_payload(state: TrainState, occ: OccupancyState,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """A stage's checkpoint (serving/state_io.py's layout): parameters,
    EMA and second moments as the JAX package's flax trees, the step and
    the optimizer's counters, the occupancy state, and the step
    generator's state, so a resumed run draws what an unbroken one
    would."""
    from ..serving.state_io import params_to_jax

    opt = state.opt.state_dict()
    return {
        "state": {
            "params": {"params": params_to_jax(
                dict(state.field.named_parameters()))},
            "ema_params": params_to_jax(state.ema),
            "step": np.int32(state.step),
            "opt_state": {
                **{k: np.int32(opt[k].item()) for k in (
                    "count", "notfinite_count", "total_notfinite")},
                "nu": params_to_jax(opt["nu"])}},
        "occ": {k: v.detach().cpu().numpy()
                for k, v in occ._asdict().items()},
        "generator": (None if generator is None else
                      {"device": generator.device.type,
                       "state": generator.get_state().numpy()})}


@torch.no_grad()
def restore_payload(state: TrainState, ck: Mapping, device,
                    generator: Optional[torch.Generator] = None,
                    log=print) -> OccupancyState:
    """Load checkpoint_payload's dict into `state` (parameters, EMA, step,
    optimizer counters and moments) and `generator` (when the checkpoint
    holds the state of a generator of this device type; else the seeded
    stream goes on, with a warning). Returns the occupancy state."""
    from ..serving.state_io import params_from_jax

    st = ck["state"]
    state.field.load_state_dict(params_from_jax(st["params"]))
    ema = params_from_jax(st["ema_params"])
    for n, e in state.ema.items():
        e.copy_(ema[n])
    state.step = int(st["step"])
    opt = dict(st["opt_state"])
    opt["nu"] = params_from_jax(opt["nu"])
    state.opt.load_state_dict(opt)
    if generator is not None:
        g = ck.get("generator")
        if g is not None and g["device"] == generator.device.type:
            generator.set_state(torch.as_tensor(g["state"]))
        else:
            log("[WARN] the checkpoint holds no generator state for "
                f"{generator.device.type}; the draws go on from the seed")
    return OccupancyState(**{
        k: torch.as_tensor(np.asarray(v), device=device)
        for k, v in ck["occ"].items()})


class Trainer:
    """A workspace's host side (the JAX package's Trainer): the log
    (<workspace>/log_ngp.txt), tensorboard scalars (tensorboardX when it
    is installed, silently off otherwise) and checkpoints, one pickle per
    step under <workspace>/checkpoints/ (serving/state_io.py's layout),
    the newest max_keep_ckpt kept. A checkpoint is written to a
    per-process temporary name and renamed into place."""

    def __init__(self, workspace: str, max_keep_ckpt: int = 2):
        import os

        self.workspace = workspace
        os.makedirs(workspace, exist_ok=True)
        self.log_path = os.path.join(workspace, "log_ngp.txt")
        self.ckpt_dir = os.path.join(os.path.abspath(workspace),
                                     "checkpoints")
        self.max_keep_ckpt = max_keep_ckpt
        self._tb = None
        self.last_extra = None

    def log(self, *args) -> None:
        msg = " ".join(str(a) for a in args)
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is None:
            try:
                import os

                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(self.workspace, "run"))
            except ImportError:
                self._tb = False
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def save_checkpoint(self, state: TrainState, occ: OccupancyState,
                        generator: Optional[torch.Generator] = None,
                        extra: Optional[Dict] = None) -> str:
        """Write the step's checkpoint (with `extra`, any picklable
        run state, under "extra") and drop all but the newest
        max_keep_ckpt."""
        import os
        import pickle

        from ..serving.state_io import checkpoint_path, checkpoint_steps

        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = checkpoint_path(self.ckpt_dir, state.step)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            ck = checkpoint_payload(state, occ, generator)
            if extra is not None:
                ck["extra"] = extra
            pickle.dump(ck, f)
        os.replace(tmp, path)
        steps = checkpoint_steps(self.ckpt_dir)
        for old in steps[:max(0, len(steps) - self.max_keep_ckpt)]:
            os.remove(checkpoint_path(self.ckpt_dir, old))
        return path

    def load_checkpoint(self, state: TrainState, occ: OccupancyState,
                        generator: Optional[torch.Generator] = None,
                        step: Optional[int] = None):
        """Restore the newest (or the given step's) checkpoint into
        `state` and `generator` -> (state, occ, restored); restored is
        False, and occ unchanged, when there is none. The checkpoint's
        "extra" is kept as self.last_extra."""
        from ..serving.state_io import read_checkpoint

        ck = read_checkpoint(self.ckpt_dir, step)
        self.last_extra = None if ck is None else ck.get("extra")
        if ck is None:
            return state, occ, False
        dev = next(state.field.parameters()).device
        occ = restore_payload(state, ck, dev, generator, log=self.log)
        return state, occ, True
