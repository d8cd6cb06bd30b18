"""The head stage of the production training recipe on the synthetic oracle
(the port's counterpart of the head stage of scripts/train_production.py).

    python3 -m lzzx_nerf_tpu_torch.tools.train_production
        [--head-iters 30000] [--res 512] [--grid 128] [--frames 32]
        [--num-rays 65536] [--budget-frac 0.75] [--warmup 1000]
        [--eval-every 2500] [--eval-res 256] [--log-every 100]
        [--workspace DIR] [--device cpu]

At the production point (512², grid 128, S 16, 65,536 rays a step) it
marks the cells no training camera sees, then runs full-path steps for
the warm-up and window-compacted steps after it (budget = budget-frac x
num-rays, in multiples of 1024), with the occupancy grid refreshed every
16 steps. The JSON lines of the JAX script (start, log, eval, stage_done)
go to stdout and to <workspace>/metrics.jsonl; ckpt_head.pkl ({"state",
"occ", "it"}, numpy leaves, the parameters as the JAX package's flax
tree) is written every --ckpt-every steps and at the end.

Steps whose gradients are not finite are skipped on the device; at each
log step the optimizer's counters are read and a [WARN] line goes to
stderr for the steps skipped since the last log, a louder one when the
backstop (more than 100 consecutive bad steps) applied a non-finite
update. The lips finetune and the torso stage are not ported yet:
--lips-iters and --torso-iters > 0 raise. The default device is the GPU;
--device cpu runs the plain PyTorch path (for tests, at a tiny size).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..data.synthetic import SyntheticTalkingHead
from ..models.nerf import NeRFField
from ..ops.march import marching_dt, num_candidates
from ..render.grid_update import make_density_grid_update, mark_untrained_grid
from ..render.state import RenderSettings, init_occupancy_state
from ..serving.state_io import params_to_jax
from ..train.metrics import psnr
from ..train.optim import HeadOptimizer
from ..train.trainer import TrainState, make_eval_step, make_train_step
from ..utils.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRID_EVERY = 16
AABB = (-1.0, -0.5, -1.0, 1.0, 0.5, 1.0)


def save_pickle(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _to_device(frame: Dict, dev) -> Dict:
    return {k: (int(v) if k == "index"
                else torch.as_tensor(np.array(v), device=dev))
            for k, v in frame.items()}


class HeadRun:
    """The head stage's world at one operating point: the oracle's frames
    on the device, the marked occupancy grid, a seeded field, its
    optimizer, the full-path and compacted steps, the grid refresh and the
    eval render."""

    def __init__(self, res: int = 512, grid: int = 128, frames: int = 32,
                 num_rays: int = 65536, budget_frac: float = 0.75,
                 warmup: int = 1000, head_iters: int = 30000,
                 eval_res: int = 256, seed: int = 0, device=None,
                 log: Callable[[str], None] = print):
        self.device = dev = resolve_device(device)
        self.warmup = warmup
        self.ds = SyntheticTalkingHead(num_frames=frames, H=res, W=res,
                                       torso=True)
        dt = marching_dt(1.0, grid, 16, 1)
        self.settings = s = RenderSettings(
            bound=1.0, cascade=1, grid_size=grid, max_steps=16, dt=dt,
            num_cand=num_candidates(AABB, 0.05, dt), aabb=AABB)
        poses = np.stack([self.ds.pose(i) for i in range(frames)])
        self.occ = mark_untrained_grid(
            s, init_occupancy_state(s, dev),
            torch.as_tensor(poses, device=dev), self.ds.intrinsics)
        self.field = NeRFField(audio_in_dim=self.ds.audio_dim,
                               ind_num=max(64, frames)).to(dev)
        self.field.init_params(torch.Generator(dev).manual_seed(seed))
        self.opt = HeadOptimizer(self.field.named_parameters(), 1e-2, 1e-3,
                                 head_iters, log=log)
        self.state = TrainState.create(self.field, self.opt)
        self.gen = torch.Generator(dev).manual_seed(seed + 1)
        self.budget = int(num_rays * budget_frac) // 1024 * 1024
        common = dict(H=res, W=res, intrinsics=self.ds.intrinsics,
                      num_rays=num_rays, iters=head_iters, ind_dim=4)
        self.step_full = make_train_step(self.field, s, **common)
        self.step_compact = make_train_step(self.field, s,
                                            train_budget=self.budget,
                                            **common)
        self.refresh = make_density_grid_update(self.field, s)
        self.frames = [_to_device(self.ds.frame(i), dev)
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
            b = _to_device(self.ds_eval.frame(fi), self.device)
            img = self.eval_step(self.state, self.occ, b)["image"]
            vals.append(float(psnr(img, b["image"])))
        return float(np.mean(vals)), [round(v, 2) for v in vals]

    def checkpoint(self, it: int) -> Dict:
        """ckpt_head.pkl's payload: the JAX script's layout (state, occ,
        it) with numpy leaves; the parameters and their EMA as flax
        trees, so the JAX NeRFField loads them."""
        st = self.state
        opt = self.opt.state_dict()
        return {
            "state": {
                "params": {"params": params_to_jax(
                    dict(self.field.named_parameters()))},
                "ema_params": params_to_jax(st.ema),
                "step": np.int32(st.step),
                "opt_state": {
                    "count": np.int32(opt["count"].item()),
                    "notfinite_count": np.int32(
                        opt["notfinite_count"].item()),
                    "total_notfinite": np.int32(
                        opt["total_notfinite"].item()),
                    "nu": params_to_jax(opt["nu"])}},
            "occ": {k: v.cpu().numpy() for k, v in self.occ._asdict().items()},
            "it": it}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workspace", default=os.path.join(_REPO,
                                                        "trained_torch"))
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--num-rays", type=int, default=65536)
    ap.add_argument("--head-iters", type=int, default=30000)
    ap.add_argument("--lips-iters", type=int, default=0)
    ap.add_argument("--torso-iters", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=1000,
                    help="full-path steps before the compacted step takes "
                    "over")
    ap.add_argument("--budget-frac", type=float, default=0.75)
    ap.add_argument("--eval-every", type=int, default=2500)
    ap.add_argument("--eval-res", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain PyTorch path")
    args = ap.parse_args(argv)
    for stage, n in (("lips", args.lips_iters), ("torso", args.torso_iters)):
        if n > 0:
            raise NotImplementedError(
                f"--{stage}-iters: the {stage} stage is not ported yet (a "
                "later slice of the training port); this tool runs the "
                "head stage")

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

        dev = run.device
        emit(event="start", stage="head", res=args.res, grid=args.grid,
             frames=args.frames, num_rays=args.num_rays,
             head_iters=args.head_iters, n_params=run.n_params(),
             platform="gpu" if dev.type == "cuda" else dev.type,
             device=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
             train_budget=run.budget)
        ckpt = os.path.join(args.workspace, "ckpt_head.pkl")
        t_stage = time.time()
        last_t, last_it = t_stage, 0
        for it in range(args.head_iters):
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
                     psnr=round(mean_db, 2), per_frame=per,
                     res=args.eval_res)
            if done % args.ckpt_every == 0 or done == args.head_iters:
                save_pickle(ckpt, run.checkpoint(done))
        emit(event="stage_done", stage="head",
             minutes=round((time.time() - t_stage) / 60, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
