"""The training steps and the eval render (port of
lzzx_nerf_tpu/train/trainer.py: TrainState, make_train_step,
make_eval_step, make_torso_train_step).

A head step: random rays of one frame (or, for the lips finetune, the
fixed lips_pad² crop at the frame's lips rect), the audio code, the field
through the full-path march (render_rays) or the window-compacted one
(render_rays_train_compact, optionally staged; never under the lips
finetune), the head loss stack, LPIPS on the lips crop or on the patches
of a patch-sampled step, the every-16-steps jitter regulariser (off under
the lips finetune), backward, the optimizer (non-finite steps skipped on
the device) and the periodic EMA; the data-parallel step renders a
rank's shard of the rays and sums the ranks' gradients. A torso step: random pixels,
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
from ..parallel.mesh import DataSharding
from ..render.renderer import (effective_train_stage2_budget, render_rays,
                               render_rays_train_compact, run_torso)
from ..render.state import OccupancyState, RenderSettings
from ..utils.pose import camera_refinement
from ..utils.rays import get_bg_coords, get_rays, patch_inds
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


def _masked_mse(a, b, w, total=None):
    """sum((a - b)² w) / max(sum(w), 1); `total` sums a per-rank partial
    sum over the ranks of a data-parallel step (the global value)."""
    w = w.to(torch.float32)
    num, den = torch.sum(((a - b) ** 2) * w), torch.sum(w)
    if total is not None:
        num, den = total(num), total(den)
    return num / torch.clamp(den, min=1.0)


def jitter_regulariser(field: NeRFField, pts: torch.Tensor,
                       dirs: torch.Tensor, mask: torch.Tensor,
                       enc_a: torch.Tensor, c: Optional[torch.Tensor],
                       eye: torch.Tensor, delta: torch.Tensor,
                       packed: Dict[str, torch.Tensor], *,
                       unc_loss: bool = True, amb_aud_loss: bool = True,
                       amb_eye_loss: bool = True, total=None
                       ) -> torch.Tensor:
    """The every-16-steps regulariser: masked MSEs of the uncertainty and
    ambient outputs at the jittered samples pts + delta against their
    detached values at pts, with the audio and individual codes detached
    (reference TrainerUtil.py:346-365, via the JAX package's step).
    total: DataSharding.total of a data-parallel step, whose ranks hold
    different sample counts (each MSE is the global one)."""
    ea = enc_a.detach()
    cc = c.detach() if c is not None else None
    with torch.no_grad():
        raw = field(pts, dirs, ea, cc, eye, compute_uncertainty=unc_loss,
                    packed=packed)
    per = field(pts + delta, dirs, ea, cc, eye,
                compute_uncertainty=unc_loss, packed=packed)
    reg = pts.new_zeros(())
    if unc_loss:
        reg = reg + _masked_mse(raw.uncertainty, per.uncertainty, mask,
                                total)
    if amb_aud_loss:
        reg = reg + _masked_mse(raw.ambient_aud, per.ambient_aud, mask,
                                total)
    if amb_eye_loss:
        reg = reg + _masked_mse(raw.ambient_eye, per.ambient_eye, mask,
                                total)
    return reg


def _f32_ratio(a: int, b: int) -> float:
    """a / b rounded like the JAX package's float32 division."""
    return float(np.float32(a) / np.float32(b))


# the per-ray outputs the loss reads, gathered from every rank of a
# data-parallel step (image takes 3 columns)
_LOSS_ROWS = ("image", "weights_sum", "ambient_aud", "ambient_eye",
              "uncertainty")


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
                    train_camera: bool = False, exp_eye: bool = True,
                    data_sharding: Optional[DataSharding] = None,
                    train_budget: int = 0, train_stage_split: int = 0,
                    train_stage2_budget: int = 0):
    """Returns step(state, occ, batch, generator=None, draws=None) ->
    metrics. train_budget > 0 selects the compacted step (not under the
    lips finetune), and 0 < train_stage_split < S its staged composite
    (train_stage2_budget stage-2 slots, 0 for the renderer's default;
    metrics n_stage2 and n_stage2_over against the effective budget).
    patch_size > 1: the rays are N // p² whole p x p patches
    (utils.rays.patch_inds), and with lpips_params the loss adds 0.1 x the
    mean LPIPS of the rendered patches against the ground truth.
    finetune_lips: rays on the lips_pad² crop at batch["rect_origin"], no
    uncertainty terms, no regulariser, and 0.01 x LPIPS (lpips_params, on
    the step's device) of the crop. exp_eye False: the field gets no eye
    value (its eye branch is off) and no blink jitter is drawn.

    data_sharding (parallel.data_sharding over a process group's mesh):
    the data-parallel step. Every rank draws the same global rays, noise
    and jitter, renders its contiguous slice of the rays (the compacted
    step compacts per shard: max(256, budget // n) slots, max(1024,
    stage2 // n) stage-2 slots, the overflow weights per shard), gathers
    every rank's per-ray outputs, and computes the loss of the whole batch
    (the regulariser's sums over its samples are summed over the ranks);
    the gradients are summed over the ranks before the optimizer, which,
    like the EMA, runs replicated. n_active and n_stage2 are summed over
    the ranks, n_active_over and n_stage2_over are the worst shard's
    excess over its slots. num_rays must divide by the ranks.

    batch: image [H, W, 3], bg_color [H, W, 3], face_mask [H, W] bool,
    pose [4, 4], auds [8, 16, C] (label features [8, 16] under emb),
    eye [1], index (int), and for the lips
    finetune rect_origin [2] int (row, col), on the step's device. draws:
    tensors that replace the generator's draws (any subset; the rest come
    from the generator), uniform in [0, 1) unless said otherwise: "inds"
    [N] int pixel indices in [0, H*W) (not drawn under the lips finetune;
    patch_inds' layout under patch_size > 1); "noise" [N], the march
    lattice jitter; "eye_jitter" (eye's shape), the blink jitter (u - 0.5)
    / 10; "reg_delta" [M, 3] over the step's M samples (of every rank),
    the regulariser's jitter (u * 2 - 1) * 1e-3."""
    if train_camera and not hasattr(field, "camera_dR"):
        raise ValueError("train_camera needs a field built with "
                         "camera_frames > 0")
    dev = next(field.parameters()).device
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    S = settings.max_steps
    use_compact = train_budget > 0 and not finetune_lips
    use_lpips = finetune_lips and lpips_params is not None
    # the patch term belongs to the patch-sampled steps, not to the lips
    # crop
    patch_lpips = (patch_size > 1 and lpips_params is not None
                   and not finetune_lips)
    lips_ar = torch.arange(lips_pad, device=dev)
    decay_rate = np.float32(lr_decay_rate(finetune_lips))
    sh = data_sharding
    n_sh = 1 if sh is None else sh.size
    if sh is not None:
        # the step's global ray count must split evenly over the ranks
        p2 = patch_size * patch_size
        sh.n_local(lips_pad * lips_pad if finetune_lips
                   else min(num_rays, H * W) // p2 * p2)
    budget, budget2 = train_budget, train_stage2_budget
    if sh is not None and use_compact:
        # per-shard slots (the JAX package's b_local, b2_local)
        budget = max(256, train_budget // n_sh)
        budget2 = (max(1024, train_stage2_budget // n_sh)
                   if train_stage2_budget else 0)
    cap2 = effective_train_stage2_budget(budget, budget2)

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
        elif patch_size > 1:
            inds = _draw(dev, draws, generator, "inds",
                         lambda g: patch_inds(H, W, num_rays, patch_size, g,
                                              dev))
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
        if sh is not None:
            # this rank's contiguous slice of the global rays
            rays_o, rays_d, bg, noise = (sh.slice(x) for x in (
                rays_o, rays_d, bg, noise))

        state.opt.zero_grad()
        enc_a = field.encode_audio_train(batch["auds"])
        c = field.individual_codes[batch["index"]] if ind_dim > 0 else None
        eye = None
        if exp_eye:
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
                field_fn, settings, occ, rays_o, rays_d, bg, budget,
                noise=noise, stage_split=train_stage_split,
                stage2_budget=budget2, aabb=aabb)
            ray_weight = res["ray_weight"]
        else:
            res = render_rays(field_fn, settings, occ, rays_o, rays_d, bg,
                              noise=noise, training=True, aabb=aabb)
        if sh is not None:
            # every rank's per-ray outputs, in ray order
            cols = torch.cat([res["image"]] + [
                res[k][:, None] for k in _LOSS_ROWS[1:]]
                + ([ray_weight[:, None]] if ray_weight is not None
                   else []), dim=-1)
            full = sh.gather_rows(cols)
            res = {**res, "image": full[:, :3],
                   **{k: full[:, 3 + i] for i, k in
                      enumerate(_LOSS_ROWS[1:])}}
            if ray_weight is not None:
                ray_weight = full[:, 3 + len(_LOSS_ROWS) - 1]
        loss = head_losses(res, res["image"], gt, face, step_factor,
                           unc_loss=unc_loss, amb_aud_loss=amb_aud_loss,
                           amb_eye_loss=amb_eye_loss, lambda_amb=lambda_amb,
                           max_steps=S, finetune_lips_active=finetune_lips,
                           ray_weight=ray_weight)
        if patch_lpips:
            shape = (-1, patch_size, patch_size, 3)
            loss = loss + 0.1 * torch.mean(lpips_mod.lpips(
                lpips_params, res["image"].reshape(shape) * 2 - 1,
                gt.reshape(shape) * 2 - 1))
        if use_lpips:
            shape = (1, lips_pad, lips_pad, 3)
            loss = loss + 0.01 * torch.mean(lpips_mod.lpips(
                lpips_params, res["image"].reshape(shape) * 2 - 1,
                gt.reshape(shape) * 2 - 1))

        if not finetune_lips and step % update_extra_interval == 0:
            pts, d_s, mask = res["rays"]
            M = pts.shape[0]
            u = _draw(dev, draws, generator, "reg_delta",
                      lambda g: torch.rand((M * n_sh, 3), generator=g,
                                           device=dev))
            if sh is not None:
                u = sh.slice(u)
            reg = jitter_regulariser(
                field, pts, d_s, mask, enc_a, c, eye, (u * 2 - 1) * 1e-3,
                tables, unc_loss=unc_loss, amb_aud_loss=amb_aud_loss,
                amb_eye_loss=amb_eye_loss,
                total=None if sh is None else sh.total)
            loss = loss + step_factor * 1e-5 * reg

        loss.backward()
        if sh is not None:
            sh.all_reduce_grads(field.parameters())
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
            for k, cap in (("n_active", budget), ("n_stage2", cap2)):
                if k not in res:
                    continue
                # overflow is a per-shard event: the worst shard's excess
                per = res[k] if sh is None else sh.counts(res[k])
                metrics[k] = per.sum()
                metrics[k + "_over"] = per.max() - cap
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
                   ind_dim: int = 4, exp_eye: bool = True,
                   use_ema: bool = False):
    """Full-frame eval render (render_rays, no jitter, individual code 0,
    no eye value when exp_eye is False):
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
            eye = batch["eye"] if exp_eye else None
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
