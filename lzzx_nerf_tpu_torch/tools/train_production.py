"""The production training recipe on the synthetic oracle (the port's
counterpart of scripts/train_production.py): head, then lips finetune,
then torso, the final full-resolution eval, and production_state.pkl.

    python3 -m lzzx_nerf_tpu_torch.tools.train_production
        [--head-iters 30000] [--lips-iters 2000] [--torso-iters 100000]
        [--res 512] [--grid 128] [--frames 32] [--num-rays 65536]
        [--budget-frac 0.75] [--warmup 1000] [--lips-pad 64]
        [--eval-every 2500] [--eval-res 256] [--ckpt-every 5000]
        [--log-every 100] [--resume] [--workspace DIR] [--device cpu]

Head stage (production point: 512², grid 128, S 16, 65,536 rays a step):
the cells no training camera sees are marked, then full-path steps for the
warm-up and window-compacted steps after it (budget = budget-frac x
num-rays, in multiples of 1024), with the occupancy grid refreshed every
16 steps. ckpt_head.pkl ({"state", "occ", "it"}, numpy leaves, the
parameters, their EMA and the optimizer's second moments as flax trees,
plus the step generator's state) is written every --ckpt-every steps and
at the end; --resume continues the head stage from it.

Lips stage: the head's parameters go on at a 0.05-per-iters decay, with
the EMA seeded from the head's; every step renders the --lips-pad² crop
at the oracle's lips rect (the lower centre of the projected head) and
adds 0.01 x LPIPS. The LPIPS weights are $LZZX_LPIPS_NPZ or
~/.cache/lzzx/lpips_alex.npz when present, else the fixed-seed random
backbone (the start event names which).

Torso stage (head frozen): num-rays random pixels a step over a white
background against the torso-over-background composite, the torso grid
refreshed every 16 steps; the parameters of the best torso eval and the
torso grid they were evaluated with are kept; ckpt_torso.pkl is written
every 4 x --ckpt-every steps and at the end.

Then PSNR and LPIPS at --res over the four eval frames (one render each),
and production_state.pkl: head_ema (flax tree), torso_leaves (in
serving/state_io.TORSO_LEAF_PATHS order), occ (with the torso grid) and
meta (res, grid, frames, audio_dim, aabb, dt, intrinsics, poses, the three
iteration counts, final_psnr). The JAX script's head_leaves, head_treedef
and torso_treedef are absent: a PyTreeDef cannot be pickled without JAX.
serving/state_io.load_trained_state and ServingSession read the file, as
they read the JAX-written one.

The JSON lines of the JAX script (start, log, eval, stage_done,
best_torso, eval_final, done) go to stdout and to
<workspace>/metrics.jsonl. Steps whose gradients are not finite are
skipped on the device; at each log step the optimizer's counters are read
and a [WARN] line goes to stderr for the steps skipped since the last
log. The default device is the GPU; --device cpu runs the plain PyTorch
path (for tests, at a tiny size).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.synthetic import SyntheticTalkingHead
from ..models.nerf import NeRFField, TorsoField
from ..ops.march import marching_dt, num_candidates
from ..render.grid_update import (make_density_grid_update,
                                  make_torso_grid_update, mark_untrained_grid)
from ..render.renderer import run_torso
from ..render.state import (OccupancyState, RenderSettings,
                            init_occupancy_state)
from ..serving.state_io import (TORSO_LEAF_PATHS, flatten_paths,
                                params_to_jax)
from ..train import lpips as lpips_mod
from ..train.metrics import psnr
from ..train.optim import HeadOptimizer
from ..train.trainer import (TrainState, checkpoint_payload,
                             make_eval_step, make_torso_train_step,
                             make_train_step, restore_payload, to_device)
from ..utils.device import resolve_device
from ..utils.rays import get_bg_coords

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRID_EVERY = 16
AABB = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)
IND_DIM_TORSO = 8


def save_pickle(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _state_checkpoint(state: TrainState, occ: OccupancyState, it: int,
                      gen: torch.Generator) -> Dict:
    """A stage's checkpoint in the JAX script's layout ({"state", "occ",
    "it"}, numpy leaves, the parameters as the JAX package's flax tree),
    plus the step generator's state."""
    return {**checkpoint_payload(state, occ, gen), "it": it}


class HeadRun:
    """The head stage's world at one operating point: the oracle's frames
    on the device, the marked occupancy grid, a seeded field, its
    optimizer, the full-path and compacted steps, the grid refresh and the
    eval render. The lips and torso stages build on it (LipsRun,
    TorsoRun) and share its occupancy state and step generator."""

    def __init__(self, res: int = 512, grid: int = 128, frames: int = 32,
                 num_rays: int = 65536, budget_frac: float = 0.75,
                 warmup: int = 1000, head_iters: int = 30000,
                 eval_res: int = 256, seed: int = 0, device=None,
                 log: Callable[[str], None] = print):
        self.device = dev = resolve_device(device)
        self.res, self.seed, self.log = res, seed, log
        self.warmup = warmup
        self.ds = SyntheticTalkingHead(num_frames=frames, H=res, W=res,
                                       torso=True)
        dt = marching_dt(1.0, grid, 16, 1)
        self.settings = s = RenderSettings(
            bound=1.0, cascade=1, grid_size=grid, max_steps=16, dt=dt,
            num_cand=num_candidates(AABB, 0.05, dt), aabb=AABB)
        self.poses = np.stack([self.ds.pose(i) for i in range(frames)])
        self.occ = mark_untrained_grid(
            s, init_occupancy_state(s, dev),
            torch.as_tensor(self.poses, device=dev), self.ds.intrinsics)
        self.field = NeRFField(audio_in_dim=self.ds.audio_dim,
                               ind_num=max(64, frames)).to(dev)
        self.field.init_params(torch.Generator(dev).manual_seed(seed))
        self.opt = HeadOptimizer(self.field.named_parameters(), 1e-2, 1e-3,
                                 head_iters, log=log)
        self.state = TrainState.create(self.field, self.opt)
        self.gen = torch.Generator(dev).manual_seed(seed + 1)
        self.budget = int(num_rays * budget_frac) // 1024 * 1024
        self.num_rays = num_rays
        self.common = dict(H=res, W=res, intrinsics=self.ds.intrinsics,
                           num_rays=num_rays, iters=head_iters, ind_dim=4)
        self.step_full = make_train_step(self.field, s, **self.common)
        self.step_compact = make_train_step(self.field, s,
                                            train_budget=self.budget,
                                            **self.common)
        self.refresh = make_density_grid_update(self.field, s)
        self.frames = [to_device(self.ds.frame(i), dev)
                       for i in range(frames)]
        self.eval_res = eval_res
        self.ds_eval = SyntheticTalkingHead(num_frames=frames, H=eval_res,
                                            W=eval_res, torso=True)
        self.eval_frames = list(range(1, frames,
                                      max(1, frames // 4)))[:4]
        self.eval_step = make_eval_step(self.field, s, H=eval_res,
                                        W=eval_res,
                                        intrinsics=self.ds_eval.intrinsics)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.field.parameters())

    def refresh_grid(self, it: int) -> None:
        b = self.frames[it % len(self.frames)]
        self.occ = self.refresh(self.occ, b["auds"], b["eye"], self.gen)

    def train_step(self, it: int, compact: bool = None) -> Dict:
        """Step `it` on frame it mod frames: compacted after the warm-up
        unless `compact` says otherwise. Refreshes nothing."""
        if compact is None:
            compact = it >= self.warmup
        step = self.step_compact if compact else self.step_full
        return step(self.state, self.occ, self.frames[it % len(self.frames)],
                    self.gen)

    def step(self, it: int) -> Dict:
        """The recipe's iteration: the grid refresh every 16 steps, then
        the step."""
        if it % GRID_EVERY == 0:
            self.refresh_grid(it)
        return self.train_step(it)

    def eval_psnr(self) -> Tuple[float, List[float]]:
        """Mean PSNR (and per frame) of eval_res renders of the eval
        frames against the oracle."""
        vals = []
        for fi in self.eval_frames:
            b = to_device(self.ds_eval.frame(fi), self.device)
            img = self.eval_step(self.state, self.occ, b)["image"]
            vals.append(float(psnr(img, b["image"])))
        return float(np.mean(vals)), [round(v, 2) for v in vals]

    def checkpoint(self, it: int) -> Dict:
        """ckpt_head.pkl's payload."""
        return _state_checkpoint(self.state, self.occ, it, self.gen)

    def restore(self, ck: Mapping) -> int:
        """Load a checkpoint() payload: parameters, EMA, step count,
        optimizer counters and moments, occupancy state and, when it was
        written on this device type, the generator's state (else the
        seeded stream goes on, with a warning). Returns its iteration."""
        self.occ = restore_payload(self.state, ck, self.device, self.gen,
                                   log=self.log)
        return int(ck["it"])


def lips_rects(ds: SyntheticTalkingHead, res: int, pad: int) -> List:
    """The oracle's lips rect origin (row, col) per frame: the lower
    centre of the projected head sphere."""
    fx = ds.intrinsics[0]
    out = []
    for i in range(ds.num_frames):
        r_pix = fx * ds.radius(i) / ds.cam_dist
        out.append((int(min(res - pad, res / 2 + 0.25 * r_pix)),
                    int(res / 2 - pad / 2)))
    return out


class LipsRun:
    """The lips finetune over a HeadRun's field: a fresh optimizer (decay
    0.05 per lips_iters) over the head's parameters, the EMA seeded from
    the head's, the lips step (LPIPS on the lips_pad² crop) and its
    frames. finish() hands the EMA back to the head's state."""

    def __init__(self, head: HeadRun, lips_iters: int, lips_pad: int = 64,
                 lpips_params: Optional[Mapping] = None):
        if lips_pad > head.res:
            raise ValueError(f"--lips-pad {lips_pad} exceeds the frame "
                             f"({head.res}²)")
        self.head = head
        self.opt = HeadOptimizer(head.field.named_parameters(), 1e-2, 1e-3,
                                 lips_iters, finetune_lips=True,
                                 log=head.log)
        self.state = TrainState(
            field=head.field, opt=self.opt,
            ema={n: e.clone() for n, e in head.state.ema.items()})
        self.step_fn = make_train_step(
            head.field, head.settings, finetune_lips=True, lips_pad=lips_pad,
            lpips_params=lpips_params, **head.common)
        dev = head.device
        self.frames = [
            dict(b, rect_origin=torch.tensor(r, device=dev))
            for b, r in zip(head.frames, lips_rects(head.ds, head.res,
                                                    lips_pad))]

    def step(self, it: int) -> Dict:
        return self.step_fn(self.state, self.head.occ,
                            self.frames[it % len(self.frames)],
                            self.head.gen)

    def finish(self) -> None:
        self.head.state.ema = self.state.ema


class TorsoRun:
    """The torso stage over a HeadRun's world (its head frozen): a seeded
    TorsoField, its optimizer, the torso step over a white background, the
    torso grid refresh and the eval of the composite. The torso grid lives
    in the head run's occupancy state."""

    def __init__(self, head: HeadRun, torso_iters: int):
        self.head = head
        dev = head.device
        self.torso = TorsoField(ind_dim_torso=IND_DIM_TORSO,
                                ind_num=max(64, len(head.frames))).to(dev)
        self.torso.init_params(
            torch.Generator(dev).manual_seed(head.seed + 2))
        self.opt = HeadOptimizer(self.torso.named_parameters(), 1e-2, 1e-3,
                                 torso_iters, log=head.log)
        self.state = TrainState.create(self.torso, self.opt)
        s = head.settings
        self.step_fn = make_torso_train_step(
            self.torso, s, H=head.res, W=head.res, num_rays=head.num_rays,
            ind_dim_torso=IND_DIM_TORSO)
        self.refresh = make_torso_grid_update(self.torso, s, IND_DIM_TORSO)
        ones = torch.ones((head.res, head.res, 3), device=dev)
        self.frames = [dict(b, bg_color=ones) for b in head.frames]
        er = head.eval_res
        self.bg_coords_eval = get_bg_coords(er, er, device=dev)[0]
        self.bg_eval = torch.ones((er * er, 3), device=dev)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.torso.parameters())

    def refresh_grid(self, it: int) -> None:
        b = self.frames[it % len(self.frames)]
        self.head.occ = self.refresh(self.head.occ, b["pose"], self.head.gen)

    def train_step(self, it: int) -> Dict:
        return self.step_fn(self.state, self.head.occ,
                            self.frames[it % len(self.frames)],
                            self.head.gen)

    def step(self, it: int) -> Dict:
        if it % GRID_EVERY == 0:
            self.refresh_grid(it)
        return self.train_step(it)

    @torch.no_grad()
    def eval_psnr(self) -> Tuple[float, List[float]]:
        """Mean PSNR (and per frame) of the torso composited over white at
        eval_res against the oracle's torso-over-background composite,
        each frame with its own torso code."""
        h = self.head
        vals = []
        for fi in h.eval_frames:
            b = h.ds_eval.frame(fi)
            out = run_torso(self.torso.train_forward, h.settings, h.occ,
                            self.bg_coords_eval,
                            torch.as_tensor(b["pose"], device=h.device),
                            self.torso.individual_codes_torso[fi],
                            self.bg_eval)
            gt = torch.as_tensor(b["bg_torso_color"],
                                 device=h.device).reshape(-1, 3)
            vals.append(float(psnr(out["bg_color"], gt)))
        return float(np.mean(vals)), [round(v, 2) for v in vals]

    def checkpoint(self, it: int) -> Dict:
        """ckpt_torso.pkl's payload."""
        return _state_checkpoint(self.state, self.head.occ, it,
                                 self.head.gen)


def final_eval(head: HeadRun, lpips_params: Mapping
               ) -> Tuple[float, List[float], float]:
    """PSNR and LPIPS at the training resolution over the eval frames,
    both from one render each (individual code 0, the live parameters)
    -> (mean PSNR, per-frame PSNR, mean LPIPS)."""
    r = head.res
    ev = make_eval_step(head.field, head.settings, H=r, W=r,
                        intrinsics=head.ds.intrinsics)
    pvals, lvals = [], []
    for fi in head.eval_frames:
        b = head.frames[fi]
        img = ev(head.state, head.occ, b)["image"]
        pvals.append(float(psnr(img, b["image"])))
        with torch.no_grad():
            lvals.append(float(torch.mean(lpips_mod.lpips(
                lpips_params, img.reshape(1, r, r, 3) * 2.0 - 1.0,
                b["image"].reshape(1, r, r, 3) * 2.0 - 1.0))))
    return (float(np.mean(pvals)), [round(v, 2) for v in pvals],
            float(np.mean(lvals)))


def production_state(head: HeadRun, torso: TorsoField, args,
                     final_psnr: float) -> Dict:
    """production_state.pkl's payload (see the module docstring)."""
    tflat = flatten_paths(params_to_jax(dict(torso.named_parameters())))
    if set(tflat) != set(TORSO_LEAF_PATHS):
        raise ValueError(f"torso leaves {sorted(tflat)} are not "
                         "TORSO_LEAF_PATHS")
    ds = head.ds
    return {
        "head_ema": params_to_jax(head.state.ema),
        "torso_leaves": [tflat[p] for p in TORSO_LEAF_PATHS],
        "occ": {k: v.cpu().numpy() for k, v in head.occ._asdict().items()},
        "meta": {"res": head.res, "grid": head.settings.grid_size,
                 "frames": ds.num_frames, "audio_dim": ds.audio_dim,
                 "aabb": AABB, "dt": head.settings.dt,
                 "intrinsics": ds.intrinsics, "poses": head.poses,
                 "head_iters": args.head_iters,
                 "torso_iters": args.torso_iters,
                 "lips_iters": args.lips_iters, "final_psnr": final_psnr}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workspace", default=os.path.join(_REPO,
                                                        "trained_torch"))
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--num-rays", type=int, default=65536)
    ap.add_argument("--head-iters", type=int, default=30000)
    ap.add_argument("--lips-iters", type=int, default=2000)
    ap.add_argument("--torso-iters", type=int, default=100000)
    ap.add_argument("--warmup", type=int, default=1000,
                    help="full-path steps before the compacted step takes "
                    "over")
    ap.add_argument("--budget-frac", type=float, default=0.75)
    ap.add_argument("--lips-pad", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=2500)
    ap.add_argument("--eval-res", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="resume the head stage from ckpt_head.pkl if "
                    "present")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)

    def warn(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    run = HeadRun(res=args.res, grid=args.grid, frames=args.frames,
                  num_rays=args.num_rays, budget_frac=args.budget_frac,
                  warmup=args.warmup, head_iters=args.head_iters,
                  eval_res=args.eval_res, seed=args.seed,
                  device=args.device, log=warn)
    os.makedirs(args.workspace, exist_ok=True)
    t0 = time.time()
    with open(os.path.join(args.workspace, "metrics.jsonl"), "a",
              buffering=1) as mlog:

        def emit(**kw):
            kw["t"] = round(time.time() - t0, 1)
            mlog.write(json.dumps(kw) + "\n")
            print(json.dumps(kw), flush=True)

        _recipe(args, run, emit, t0)
    return 0


def _recipe(args, run: HeadRun, emit, t0: float) -> None:
    dev = run.device
    emit(event="start", stage="head", res=args.res, grid=args.grid,
         frames=args.frames, num_rays=args.num_rays,
         head_iters=args.head_iters, n_params=run.n_params(),
         platform="gpu" if dev.type == "cuda" else dev.type,
         device=(torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "cpu"),
         train_budget=run.budget)

    # ---- head stage
    ckpt = os.path.join(args.workspace, "ckpt_head.pkl")
    start_it = 0
    if args.resume and os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            start_it = run.restore(pickle.load(f))
        emit(event="resume", stage="head", it=start_it)
    t_stage = time.time()
    last_t, last_it = t_stage, start_it
    for it in range(start_it, args.head_iters):
        m = run.step(it)
        done = it + 1
        if done % args.log_every == 0 or done == args.head_iters:
            vals = {k: float(v) for k, v in m.items()}
            run.opt.poll(done)
            now = time.time()
            its = (done - last_it) / max(now - last_t, 1e-9)
            last_t, last_it = now, done
            emit(event="log", stage="head", it=done,
                 loss=round(vals["loss"], 6), mse=round(vals["mse"], 6),
                 n_active=int(vals.get("n_active", 0)),
                 n_active_over=int(vals.get("n_active_over", 0)),
                 grad_notfinite=int(vals["grad_notfinite"]),
                 it_s=round(its, 2))
        if done % args.eval_every == 0 or done == args.head_iters:
            mean_db, per = run.eval_psnr()
            emit(event="eval", stage="head", it=done,
                 psnr=round(mean_db, 2), per_frame=per, res=args.eval_res)
        if done % args.ckpt_every == 0 or done == args.head_iters:
            save_pickle(ckpt, run.checkpoint(done))
    emit(event="stage_done", stage="head",
         minutes=round((time.time() - t_stage) / 60, 1))

    lp_path = lpips_mod.default_weights_path()
    lpips_params = lpips_mod.get_params(device=dev)

    # ---- lips finetune
    if args.lips_iters > 0:
        lips = LipsRun(run, args.lips_iters, args.lips_pad, lpips_params)
        emit(event="start", stage="lips", iters=args.lips_iters,
             lpips=(f"npz:{lp_path}" if lp_path else
                    "rand-feat (fixed seed; no pretrained npz)"),
             lips_pad=args.lips_pad)
        t_stage = time.time()
        last_t, last_it = t_stage, 0
        for it in range(args.lips_iters):
            m = lips.step(it)
            done = it + 1
            if done % args.log_every == 0 or done == args.lips_iters:
                lips.opt.poll(done)
                now = time.time()
                its = (done - last_it) / max(now - last_t, 1e-9)
                last_t, last_it = now, done
                emit(event="log", stage="lips", it=done,
                     loss=round(float(m["loss"]), 6),
                     mse=round(float(m["mse"]), 6),
                     grad_notfinite=int(m["grad_notfinite"]),
                     it_s=round(its, 2))
        mean_db, per = run.eval_psnr()
        emit(event="eval", stage="lips", it=args.lips_iters,
             psnr=round(mean_db, 2), per_frame=per, res=args.eval_res)
        emit(event="stage_done", stage="lips",
             minutes=round((time.time() - t_stage) / 60, 1))
        lips.finish()

    # ---- torso stage (head frozen)
    torso = TorsoRun(run, args.torso_iters)
    emit(event="start", stage="torso", iters=args.torso_iters,
         n_params=torso.n_params())
    ckpt_t = os.path.join(args.workspace, "ckpt_torso.pkl")
    t_stage = time.time()
    last_t, last_it = t_stage, 0
    # the best eval's parameters and the torso grid they were evaluated
    # with are shipped, not the last step's (the reference's best
    # checkpoint)
    best = None   # (psnr, it, state_dict, grid, mean)
    for it in range(args.torso_iters):
        m = torso.step(it)
        done = it + 1
        if done % (args.log_every * 10) == 0:
            torso.opt.poll(done)
            now = time.time()
            its = (done - last_it) / max(now - last_t, 1e-9)
            last_t, last_it = now, done
            emit(event="log", stage="torso", it=done,
                 loss=round(float(m["loss"]), 6),
                 grad_notfinite=int(m["grad_notfinite"]),
                 it_s=round(its, 2))
        if done % (args.eval_every * 4) == 0 or done == args.torso_iters:
            mdb, per = torso.eval_psnr()
            emit(event="eval", stage="torso", it=done, psnr=round(mdb, 2),
                 per_frame=per, res=args.eval_res)
            if best is None or mdb > best[0]:
                occ = run.occ
                best = (mdb, done,
                        {k: v.detach().clone()
                         for k, v in torso.torso.state_dict().items()},
                        occ.density_grid_torso.clone(),
                        occ.mean_density_torso.clone())
        if done % (args.ckpt_every * 4) == 0 or done == args.torso_iters:
            save_pickle(ckpt_t, torso.checkpoint(done))
    emit(event="stage_done", stage="torso",
         minutes=round((time.time() - t_stage) / 60, 1))
    if best is not None:
        mdb, bit, sd, grid, mean = best
        emit(event="best_torso", it=bit, psnr=round(mdb, 2))
        torso.torso.load_state_dict(sd)
        run.occ = run.occ._replace(density_grid_torso=grid,
                                   mean_density_torso=mean)

    # ---- final eval at --res: PSNR and LPIPS from one render per frame
    mean_db, per, lp = final_eval(run, lpips_params)
    emit(event="eval_final", stage="head", psnr=round(mean_db, 2),
         per_frame=per, res=args.res, lpips=round(lp, 4),
         lpips_weights="npz" if lp_path else "rand-feat")

    out = os.path.join(args.workspace, "production_state.pkl")
    save_pickle(out, production_state(run, torso.torso, args, mean_db))
    emit(event="done", state=out, minutes=round((time.time() - t0) / 60, 1))


if __name__ == "__main__":
    sys.exit(main())
