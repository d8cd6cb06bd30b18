"""The command line a user runs (port of lzzx_nerf_tpu/cli.py): train a
head, finetune the lips, train the torso, render a dataset offline, mesh
the density field, and render live from a wav or the microphone.

Usage (python -m lzzx_nerf_tpu_torch.cli ...):
  data/<id>/ -O --iters 100000 --workspace ws
  data/<id>/ -O --finetune_lips 1 --iters 125000 --workspace ws
  data/<id>/ -O --torso 1 --iters 200000 --workspace ws_torso
  data/<id>/ -O --test 1 --test_train 1 --torso 1 --workspace ws
  data/<id>/ -O --save_mesh 1 --workspace ws
  data/<id>/ -O --asr 1 --asr_wav speech.wav --workspace ws
  data/<id>/ -O --iters 100000 --workspace ws --data_parallel 2
  data/<id>/ -O --iters 100000 --workspace ws --patch_size 32

The flags, their defaults and -O are the JAX package's (one per field of
Config); --device (default cuda, "cpu" for the plain PyTorch path) is the
port's one addition, and an entry point without a GPU raises unless it is
given. Checkpoints are the port's own files (serving/state_io.py), one
pickle per epoch under <workspace>/checkpoints/; the torso stage trains
into its own workspace, which --test and the serving session read as
<workspace>_torso. Under --fp16 (the default, and -O) the head field
computes its audio nets and MLPs in bfloat16 from float32 parameters, as
the JAX CLI's does; the torso computes in float32.

--encoder hash builds the reference's hash-triplane head and, for the
torso stage and --test --torso, the reference's tiled torso (the JAX CLI's
rule: any encoder but dense takes the tiled torso): the fields a reference
checkpoint imported with tools/import_reference_ckpt.py holds.

--data_parallel N trains the head over N ranks, one per GPU (NCCL; with
--device cpu, N processes over gloo): under torchrun the CLI joins its
group, otherwise it starts the ranks itself; every rank samples the same
rays and renders its slice of them, rank 0 logs, evaluates and writes the
checkpoints, and a machine with fewer GPUs exits with the JAX CLI's
message. The torso stage is not sharded (as in JAX). --patch_size > 1
samples whole patches and adds 0.1 x their LPIPS (the weights' provenance
is gated as for --finetune_lips); --train_stage_split N runs the compacted
step through the staged composite.

--emb trains on label audio features (an embedding in front of the audio
net) and --exp_eye 0 a field without the eye branch, as in JAX. --test
takes the JAX CLI's serving alternates: --infer_march_group (1, 2, 3 or
a negative dilated group) with its envelope step-downs,
--infer_march_variant (every block-march variant, each marched through
nb5w's select kernel: they keep its samples), --infer_march_prepass 0 and
--infer_table_bf16 0 (float32 tables: the lookup in plain PyTorch, then
the field kernel's enc_x entry). --infer_sample_frac is a serving option
that --test ignores, as the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .train.trainer import to_device

def parse_args(argv=None):
    """argv -> (Config, device): the JAX CLI's flags (--cuda_ray accepted
    and ignored, in the spellings "--cuda_ray", "--cuda_ray 0/1" and
    "--cuda_ray=0/1" and their unambiguous prefixes) plus --device."""
    if argv is None:
        import sys
        argv = sys.argv[1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("path", type=str)
    ap.add_argument("-O", action="store_true",
                    help="equals --fp16 --exp_eye")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain PyTorch path")
    flags = {f"--{f.name}" for f in dataclasses.fields(Config)
             if f.name != "path"} | {"--cuda_ray", "--device"}

    def is_cuda_ray(tok: str) -> bool:
        base = tok.split("=", 1)[0]
        if not base.startswith("--") or len(base) < 4:
            return False
        return [n for n in flags if n.startswith(base)] == ["--cuda_ray"]

    norm, i = [], 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        _, eq, val = tok.partition("=")
        if is_cuda_ray(tok) and eq and val in ("0", "1"):
            if val == "1":
                norm.append("--cuda_ray")
            i += 1
        elif is_cuda_ray(tok) and not eq and i + 1 < len(argv) \
                and argv[i + 1] in ("0", "1"):
            if argv[i + 1] == "1":
                norm.append("--cuda_ray")
            i += 2
        else:
            norm.append(tok)
            i += 1
    ap.add_argument("--cuda_ray", action="store_true",
                    help="accepted for the reference CLI; ignored")
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name == "path":
            continue
        arg = f"--{f.name}"
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            ap.add_argument(arg, type=int, choices=[0, 1], default=None)
        elif isinstance(default, tuple):
            ap.add_argument(arg, type=float, nargs="*", default=None)
        elif isinstance(default, float):
            ap.add_argument(arg, type=float, default=None)
        elif isinstance(default, int):
            ap.add_argument(arg, type=int, default=None)
        else:
            ap.add_argument(arg, type=str, default=None)
    ns = ap.parse_args(norm)
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(ns, f.name, None)
        if v is None:
            continue
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            v = bool(v)
        elif isinstance(default, tuple):
            v = tuple(int(x) if isinstance(default[0], int) else x for x in v)
        overrides[f.name] = v
    overrides["path"] = ns.path
    if ns.O:
        overrides.setdefault("fp16", True)
        overrides.setdefault("exp_eye", True)
    return Config(**overrides), ns.device


def build_config(argv=None) -> Config:
    """The Config of a command line (the JAX CLI's build_config)."""
    return parse_args(argv)[0]


def _build_world(cfg: Config, ds, device):
    """(settings, occupancy with the cells no training camera sees
    marked, the seeded head field of cfg.encoder with the camera
    refinement when cfg.train_camera). The field computes its audio nets
    and MLPs in bfloat16 under cfg.fp16 (float32 parameters), as the JAX
    CLI's does."""
    from .models.nerf import NeRFField
    from .render.grid_update import mark_untrained_grid
    from .render.state import RenderSettings, init_occupancy_state

    settings = RenderSettings.from_config(cfg)
    occ = init_occupancy_state(settings, device)
    occ = mark_untrained_grid(settings, occ,
                              torch.as_tensor(ds.poses, device=device),
                              ds.intrinsics)
    field = NeRFField(bound=cfg.bound, audio_in_dim=cfg.audio_in_dim,
                      att=cfg.att, ind_dim=cfg.ind_dim, ind_num=cfg.ind_num,
                      exp_eye=cfg.exp_eye, emb=cfg.emb,
                      camera_frames=cfg.ind_num if cfg.train_camera else 0,
                      dtype=torch.bfloat16 if cfg.fp16 else torch.float32,
                      encoder=cfg.encoder).to(device)
    field.init_params(torch.Generator(device).manual_seed(cfg.seed))
    return settings, occ, field


def _make_torso(cfg: Config, device):
    """The seeded torso; any head encoder but dense takes the tiled torso
    (the JAX CLI's rule)."""
    from .models.nerf import TorsoField

    torso = TorsoField(
        torso_shrink=cfg.torso_shrink, ind_dim_torso=cfg.ind_dim_torso,
        ind_num=cfg.ind_num,
        encoder="dense" if cfg.encoder == "dense" else "tiled").to(device)
    torso.init_params(torch.Generator(device).manual_seed(cfg.seed))
    return torso


def _lpips_params_or_die(cfg: Config, trainer, why: str, device):
    """The LPIPS weights, loudly: an npz ($LZZX_LPIPS_NPZ or the default
    path), or the fixed-seed random backbone only with
    --allow_rand_lpips."""
    from .train import lpips as lpips_mod

    path = lpips_mod.default_weights_path()
    if path is None and not cfg.allow_rand_lpips:
        raise SystemExit(
            f"[ERROR] {why} needs pretrained LPIPS weights (none found at "
            f"$LZZX_LPIPS_NPZ or {lpips_mod.DEFAULT_WEIGHTS}).\n"
            "Export them once with scripts/export_lpips.py (any machine "
            "with the `lpips` pip package), or pass --allow_rand_lpips to "
            "knowingly train against the fixed-seed RANDOM backbone "
            "(quality diverges from the reference).")
    provenance = (f"pretrained ({path})" if path
                  else "RANDOM fixed-seed backbone (--allow_rand_lpips)")
    trainer.log(f"[INFO] {why} LPIPS weights: {provenance}")
    trainer.scalar("train/lpips_pretrained", 0.0 if path is None else 1.0, 0)
    return lpips_mod.get_params(device=device)


def run_train(cfg: Config, device=None, stop_after: Optional[int] = None
              ) -> Dict:
    """Head training (or, with --torso, the torso stage): full-path steps,
    compacted steps from train_compact_warmup on (staged with
    --train_stage_split), the lips step on odd iterations under
    --finetune_lips, the grid refresh every update_extra_interval steps, a
    checkpoint each epoch and an eval (PSNR, LPIPS,
    validation/ep####_i.png) every eval_interval epochs. A resumed run
    continues at the checkpoint's step with the draws an unbroken run
    would make (the checkpoint holds the step generator and the frame
    order's state). stop_after: end after that many steps of this call,
    at the epoch's end. --data_parallel N: the stage trains over N ranks
    (_data_parallel; the torso stage replicated on each, as the JAX CLI
    does not shard it); a rank's call returns like a single-device one,
    and a call that started the ranks returns {}. Returns {"state",
    "occ", "schedule": (iteration, "full" | "compact" | "lips",
    refreshed) per step}."""
    from .utils.device import resolve_device

    dev = resolve_device(device)
    sharding = None
    if cfg.data_parallel > 0:
        import torch.distributed as dist

        alone = not dist.is_initialized()
        sharding = _data_parallel(cfg, dev, stop_after)
        if sharding is None:
            # this process started the ranks, and they have finished
            return {}
        if alone and sharding.size == 1:
            # the group of one this call formed ends with it
            try:
                return _run_train(cfg, sharding.mesh.device, stop_after,
                                  sharding)
            finally:
                dist.destroy_process_group()
        dev = sharding.mesh.device
    return _run_train(cfg, dev, stop_after, sharding)


def _run_train(cfg: Config, dev: torch.device, stop_after: Optional[int],
               sharding) -> Dict:
    from .data.provider import NeRFDataset
    from .parallel.distributed import is_coordinator
    from .render.grid_update import make_density_grid_update
    from .train.metrics import LPIPSMeter, PSNRMeter
    from .train.optim import HeadOptimizer
    from .train.trainer import (TrainState, Trainer, make_eval_step,
                                make_train_step)

    lead = is_coordinator()
    ds = NeRFDataset(cfg, type="train")
    trainer = Trainer(cfg.workspace, max_keep_ckpt=cfg.max_keep_ckpt)
    if not lead:
        # rank-0-only IO: concurrent appends interleave, concurrent
        # checkpoint writes of one workspace race
        trainer.log = trainer.scalar = trainer.save_checkpoint = _quiet
    if sharding is not None:
        trainer.log(f"[INFO] data-parallel over {sharding.size} devices")
    trainer.log(f"[INFO] {len(ds.poses)} train frames, res {ds.H}x{ds.W}, "
                f"encoder={cfg.encoder}, iters={cfg.iters}")
    # one JSON document per line, appended per run; the serving session
    # adopts the last line when it loads this workspace
    if lead:
        with open(os.path.join(cfg.workspace, "opt.txt"), "a") as f:
            f.write(cfg.to_json(indent=None) + "\n")
    if cfg.torso:
        return run_train_torso(cfg, ds, trainer, dev, stop_after)
    val = NeRFDataset(cfg, type="val")
    settings, occ, field = _build_world(cfg, ds, dev)
    opt = HeadOptimizer(field.named_parameters(), cfg.lr, cfg.lr_net,
                        cfg.iters, cfg.finetune_lips, log=trainer.log)
    state = TrainState.create(field, opt)
    gen = torch.Generator(dev).manual_seed(cfg.seed + 1)
    state, occ, resumed = trainer.load_checkpoint(state, occ, gen)
    if resumed:
        trainer.log(f"[INFO] resumed at step {state.step}")
        _restore_order(ds, trainer)

    common = dict(H=ds.H, W=ds.W, intrinsics=ds.intrinsics,
                  num_rays=cfg.num_rays, iters=cfg.iters,
                  patch_size=cfg.patch_size, unc_loss=cfg.unc_loss,
                  amb_aud_loss=cfg.amb_aud_loss,
                  amb_eye_loss=cfg.amb_eye_loss, lambda_amb=cfg.lambda_amb,
                  ind_dim=cfg.ind_dim, ema_decay=cfg.ema_decay,
                  ema_interval=cfg.ema_update_interval,
                  update_extra_interval=cfg.update_extra_interval,
                  train_camera=cfg.train_camera, exp_eye=cfg.exp_eye,
                  data_sharding=sharding)
    # patch-sampled training carries the reference's 0.1 x LPIPS patch
    # term, not under the lips finetune
    patch_lpips = (_lpips_params_or_die(cfg, trainer, "--patch_size > 1",
                                        dev)
                   if cfg.patch_size > 1 and not cfg.finetune_lips else None)
    train_budget = (int(cfg.num_rays * cfg.train_budget_frac) // 1024 * 1024
                    if cfg.train_budget_frac > 0 else 0)
    stage2 = (max(1024, int(train_budget * cfg.train_stage2_frac)
                  // 1024 * 1024) if cfg.train_stage_split > 0 else 0)
    step_fn = make_train_step(field, settings, lpips_params=patch_lpips,
                              **common)
    compact_fn = (make_train_step(
        field, settings, lpips_params=patch_lpips, train_budget=train_budget,
        train_stage_split=cfg.train_stage_split, train_stage2_budget=stage2,
        **common) if train_budget > 0 else None)
    # the lips finetune alternates the lips-crop LPIPS step with the
    # normal step every other iteration
    lips_fn = None
    if cfg.finetune_lips:
        lips_fn = make_train_step(
            field, settings, finetune_lips=True, lips_pad=cfg.lips_crop,
            lpips_params=_lpips_params_or_die(cfg, trainer,
                                              "--finetune_lips", dev),
            **common)
    eval_fn = make_eval_step(field, settings, H=ds.H, W=ds.W,
                             intrinsics=ds.intrinsics, ind_dim=cfg.ind_dim,
                             exp_eye=cfg.exp_eye, use_ema=cfg.use_ema)
    refresh = make_density_grid_update(field, settings)
    budgets = {"train_budget": train_budget, "stage2": stage2,
               "split": cfg.train_stage_split,
               "sharded": sharding is not None}

    t_start = time.time()
    it = start = state.step
    eval_interval = cfg.eval_interval or max(
        1, int(5000 / max(len(ds.poses), 1)))
    epoch = 0
    psnr_meter, lpips_meter = PSNRMeter(), LPIPSMeter(device=dev)
    device_frames = _preload(cfg, ds, trainer, dev)
    order_rng = np.random.default_rng(cfg.seed)
    schedule: List = []
    done = {"state": state, "schedule": schedule}

    def epoch_batches():
        if device_frames is None:
            for b in ds.frames():
                yield to_device(b, dev)
        else:
            for i in order_rng.permutation(len(device_frames)):
                yield device_frames[int(i)]

    while it < cfg.iters:
        epoch += 1
        for batch in epoch_batches():
            if it >= cfg.iters:
                break
            refreshed = it % cfg.update_extra_interval == 0
            if refreshed:
                occ = refresh(occ, batch["auds"], batch["eye"], gen)
                if sharding is not None:
                    # replicated state stays bit-equal across the ranks
                    sharding.broadcast_(occ)
            if lips_fn is not None and it % 2 == 1:
                fn, kind = lips_fn, "lips"
            elif compact_fn is not None and it >= cfg.train_compact_warmup:
                fn, kind = compact_fn, "compact"
            else:
                fn, kind = step_fn, "full"
            metrics = fn(state, occ, batch, gen)
            schedule.append((it, kind, refreshed))
            it += 1
            if it % 100 == 0:
                _log_step(trainer, metrics, it, t_start, start, budgets)
        trainer.save_checkpoint(state, occ, gen, extra=_order_state(ds))
        if epoch % eval_interval == 0 and lead:
            psnr_meter.clear()
            lpips_meter.clear()
            for vi, vb in enumerate(val.frames(shuffle=False)):
                if cfg.eval_frames and vi >= cfg.eval_frames:
                    break
                out = eval_fn(state, occ, to_device(vb, dev))
                img = out["image"].cpu().numpy()
                psnr_meter.update(img, vb["image"])
                lpips_meter.update(img, vb["image"])
                _save_image(img, os.path.join(cfg.workspace, "validation",
                                              f"ep{epoch:04d}_{vi}.png"))
            trainer.log(f"[eval] epoch {epoch}: {psnr_meter.report()} | "
                        f"{lpips_meter.report()}")
            trainer.scalar("eval/psnr", psnr_meter.measure(), it)
            trainer.scalar("eval/lpips", lpips_meter.measure(), it)
        if stop_after is not None and it - start >= stop_after:
            trainer.log(f"[INFO] stopped at step {it}")
            return {**done, "occ": occ}
    trainer.save_checkpoint(state, occ, gen, extra=_order_state(ds))
    trainer.log("[INFO] training done")
    return {**done, "occ": occ}


def _quiet(*args, **kwargs) -> None:
    pass


def _data_parallel(cfg: Config, dev: torch.device,
                   stop_after: Optional[int]):
    """--data_parallel N -> this rank's DataSharding, or None when this
    process started the ranks and they have finished. Under torchrun (or
    in a rank this CLI started) the process joins the group; otherwise it
    starts N ranks (parallel.distributed.launch: one process per GPU, or
    N gloo processes under --device cpu) that run the CLI's training, or
    for N = 1 forms a group of one itself. Exits with the JAX CLI's
    message when fewer GPUs (or ranks) than N are there."""
    import torch.distributed as dist

    from .parallel import data_sharding, make_mesh
    from .parallel.distributed import (backend_for, init_distributed,
                                       launch, rank_device)

    n = cfg.data_parallel
    joined = init_distributed(dev)
    if joined:
        have = dist.get_world_size()
    else:
        have = torch.cuda.device_count() if dev.type == "cuda" else n
    if have < n:
        raise SystemExit(f"--data_parallel {n} but only {have} devices "
                         "visible")
    if joined and have != n:
        raise SystemExit(f"--data_parallel {n} in a group of {have} ranks: "
                         f"pass --data_parallel {have}")
    if not joined and n > 1:
        # CPU ranks share this process's cores
        launch(_train_rank, n, args=(cfg, dev.type, stop_after),
               device=dev.type,
               threads=(max(1, torch.get_num_threads() // n)
                        if dev.type == "cpu" else None))
        return None
    if joined:
        rd = rank_device(dev)
    else:
        rd = dev
        if dev.type == "cuda":
            if dev.index is None:
                rd = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(rd)
        # a group of one needs no rendezvous: an in-process store
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    return data_sharding(make_mesh("data", [rd], group=dist.group.WORLD))


def _train_rank(cfg: Config, device: str, stop_after: Optional[int]
                ) -> None:
    """A rank started by _data_parallel: the CLI's training in the group
    launch has joined."""
    run_train(cfg, device, stop_after)


def _order_state(ds) -> dict:
    """The frame order's generator state (the dataset's shuffle)."""
    return {"order": ds._rng.bit_generator.state}


def _restore_order(ds, trainer) -> None:
    extra = getattr(trainer, "last_extra", None) or {}
    if "order" in extra:
        ds._rng.bit_generator.state = extra["order"]


def _preload(cfg: Config, ds, trainer, dev):
    """--preload: every frame's arrays resident on the device, unless they
    exceed $LZZX_PRELOAD_BYTES (default 10 GB): then a warning and the
    frames stream from the host."""
    if not cfg.preload:
        return None
    probe = ds.frame(0)
    per_frame = sum(np.asarray(v).nbytes for v in probe.values())
    total = per_frame * len(ds)
    limit = float(os.environ.get("LZZX_PRELOAD_BYTES", 10e9))
    if total > limit:
        trainer.log(f"[WARN] --preload skipped: {len(ds)} frames x "
                    f"{per_frame/1e6:.1f} MB = {total/1e9:.1f} GB > "
                    f"{limit/1e9:.1f} GB budget (LZZX_PRELOAD_BYTES); "
                    f"streaming from host instead")
        return None
    trainer.log(f"[INFO] preloading {len(ds)} frames to device "
                f"({total/1e9:.2f} GB)")
    frames = [to_device(ds.frame(i), dev) for i in range(len(ds))]
    ds._cache.clear()
    return frames


def _log_step(trainer, metrics, it: int, t_start: float, start: int,
              budgets: Dict) -> None:
    loss_v, mse_v = float(metrics["loss"]), float(metrics["mse"])
    trainer.log(f"step {it}: loss={loss_v:.5f} mse={mse_v:.5f} "
                f"({(it - start) / (time.time() - t_start):.2f} it/s)")
    trainer.scalar("train/loss", loss_v, it)
    trainer.scalar("train/mse", mse_v, it)
    sharded = budgets["sharded"]
    if "n_active" in metrics:
        # compact-step demand: overflowing rays are left out of the loss.
        # Under --data_parallel the excess is the worst shard's over its
        # slots (the summed demand can sit under the budget while one
        # shard overflows)
        n_act = int(metrics["n_active"])
        trainer.scalar("train/n_active", n_act, it)
        over = int(metrics["n_active_over"])
        who = ("worst shard exceeds its slots" if sharded
               else "demand exceeds the budget")
        if over > 0:
            trainer.log(
                f"[WARN] train-ray budget overflow: {who} by {over} rays "
                f"(demand {n_act}, budget {budgets['train_budget']}); "
                "overflow rays are dropped from the loss (unbiased but "
                "noisy) — consider raising --train_budget_frac")
    if "n_stage2" in metrics:
        n_s2 = int(metrics["n_stage2"])
        trainer.scalar("train/n_stage2", n_s2, it)
        over = int(metrics["n_stage2_over"])
        who = ("worst shard exceeds its stage-2 slots" if sharded
               else "demand exceeds the stage-2 budget")
        if over > 0:
            trainer.log(
                f"[WARN] staged-eval survivor overflow: {who} by {over} "
                f"(demand {n_s2}, budget {budgets['stage2']}); overflowing "
                f"rays truncate at sample {budgets['split']} (biased) — "
                "raise --train_stage2_frac or set --train_stage_split 0")


def run_train_torso(cfg: Config, ds, trainer, dev,
                    stop_after: Optional[int] = None) -> Dict:
    """The torso stage (head frozen) into cfg.workspace: random pixels over
    the dataset's plain background against the torso composite, the torso
    grid refreshed every update_extra_interval steps, a checkpoint each
    epoch. It resumes from the workspace's own torso checkpoint (the JAX
    CLI starts the torso state afresh at every run)."""
    from .render.grid_update import make_torso_grid_update
    from .render.state import RenderSettings, init_occupancy_state
    from .train.optim import HeadOptimizer
    from .train.trainer import TrainState, make_torso_train_step

    settings = RenderSettings.from_config(cfg)
    occ = init_occupancy_state(settings, dev)
    torso = _make_torso(cfg, dev)
    opt = HeadOptimizer(torso.named_parameters(), cfg.lr, cfg.lr_net,
                        cfg.iters, log=trainer.log)
    state = TrainState.create(torso, opt)
    gen = torch.Generator(dev).manual_seed(cfg.seed + 1)
    state, occ, resumed = trainer.load_checkpoint(state, occ, gen)
    if resumed:
        trainer.log(f"[INFO] torso resumed at step {state.step}")
        _restore_order(ds, trainer)
    step_fn = make_torso_train_step(torso, settings, H=ds.H, W=ds.W,
                                    num_rays=cfg.num_rays,
                                    ind_dim_torso=cfg.ind_dim_torso,
                                    ema_decay=cfg.ema_decay,
                                    ema_interval=cfg.ema_update_interval)
    refresh = make_torso_grid_update(torso, settings, cfg.ind_dim_torso)
    it = start = state.step
    t0 = time.time()
    while it < cfg.iters:
        for b in ds.frames():
            if it >= cfg.iters:
                break
            batch = to_device(b, dev)
            if it % cfg.update_extra_interval == 0:
                occ = refresh(occ, batch["pose"], gen)
            metrics = step_fn(state, occ, batch, gen)
            it += 1
            if it % 100 == 0:
                trainer.log(f"[torso] step {it}: "
                            f"loss={float(metrics['loss']):.5f} "
                            f"({(it - start) / (time.time() - t0):.2f} it/s)")
        trainer.save_checkpoint(state, occ, gen, extra=_order_state(ds))
        if stop_after is not None and it - start >= stop_after:
            trainer.log(f"[INFO] stopped at step {it}")
            break
    else:
        trainer.log("[INFO] torso training done")
    return {"state": state, "occ": occ}


def _torso_workspace(workspace: str) -> str:
    ws = workspace.rstrip("/")
    return ws if ws.endswith("_torso") else ws + "_torso"


def run_save_mesh(cfg: Config, device=None) -> Dict:
    """--save_mesh: the density iso-surface of the head field as
    <workspace>/meshes/mesh_<step>.ply (the JAX CLI's run_save_mesh;
    reference TrainerUtil.save_mesh). The newest checkpoint's weights
    (the trained ones, not the EMA, as in JAX), frame 0's audio code and
    eye value; density queries over mesh_resolution³ points of the AABB
    in chunks of 65,536 on the device, marching tetrahedra on the host at
    mesh_threshold. Returns {"path", "verts", "faces", "step",
    "query_seconds", "march_seconds"}."""
    from .data.provider import NeRFDataset
    from .ops.mesh import extract_geometry, save_ply
    from .train.optim import HeadOptimizer
    from .train.trainer import Trainer, TrainState
    from .utils.device import resolve_device

    dev = resolve_device(device)
    ds = NeRFDataset(cfg, type="train")
    settings, occ, field = _build_world(cfg, ds, dev)
    trainer = Trainer(cfg.workspace)
    state = TrainState.create(field, HeadOptimizer(
        field.named_parameters(), cfg.lr, cfg.lr_net, cfg.iters))
    state, occ, _ = trainer.load_checkpoint(state, occ)
    field.eval()
    b0 = ds.frame(0)
    query_s = 0.0
    with torch.no_grad():
        enc_a = field.encode_audio(torch.as_tensor(b0["auds"], device=dev))
        eye = torch.as_tensor(b0["eye"], dtype=torch.float32, device=dev)
        # the float32 tables of the field's own in-graph bake, once
        packed = field.bake_train_tables()

        def density(pts: np.ndarray) -> np.ndarray:
            nonlocal query_s
            t = time.perf_counter()
            x = torch.as_tensor(pts, dtype=torch.float32, device=dev)
            sigma = field.density(x, enc_a, eye, packed=packed).sigma
            out = sigma.cpu().numpy()
            query_s += time.perf_counter() - t
            return out

        t0 = time.perf_counter()
        aabb = settings.aabb
        verts, faces = extract_geometry(
            aabb[:3], aabb[3:], resolution=cfg.mesh_resolution,
            threshold=cfg.mesh_threshold, query_func=density)
        march_s = time.perf_counter() - t0 - query_s
    out = os.path.join(cfg.workspace, "meshes")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"mesh_{int(state.step)}.ply")
    save_ply(path, verts, faces)
    trainer.log(f"[INFO] saved mesh: {path} "
                f"({len(verts)} verts, {len(faces)} faces); density queries "
                f"{query_s:.2f} s on {dev}, marcher {march_s:.2f} s")
    return {"path": path, "verts": len(verts), "faces": len(faces),
            "step": int(state.step), "query_seconds": query_s,
            "march_seconds": march_s}


# asr_model family -> HF checkpoint (the JAX CLI's mapping); a name with
# "/" passes through as a HF id
ASR_MODEL_IDS = {"esperanto": "cpierse/wav2vec2-large-xlsr-53-esperanto"}


def asr_feature_dim(name: str) -> int:
    """A CTC checkpoint's logit width by its HF id (the JAX CLI's rule)."""
    return 44 if "esperanto" in name else 29 if "deepspeech" in name else 32


def run_asr_live(cfg: Config, device=None) -> Dict:
    """--asr: live audio -> streamed render (the JAX CLI's run_asr_live;
    reference train.py:210-236 with asr.py's (l, m, r) contract).
    Features stream from --asr_wav (a wav replayed at the 20 ms
    microphone cadence) or the microphone (sounddevice); the hubert
    family through HubertStreamer, the CTC families through
    StreamingASR.feature_rows; frames render as soon as their attention
    context arrives (InferenceSession.run_live) into
    <workspace>/results/asr_live.mp4 (asr_live.raw, rgb24, without
    ffmpeg). --asr_save_feats writes the features in the training layout
    to <wav>.npy (results/asr_feats.npy for the microphone). The models
    and the session run on the device. Returns {"frames", "seconds",
    "out", "feats"}."""
    from .serving.asr import (StreamingASR, mic_chunk_stream,
                              wav_chunk_stream)
    from .serving.session import InferenceSession
    from .serving.streaming import make_sink

    # the session is built with asr=False: cfg.asr makes the provider skip
    # the dataset's audio, which the plan's audio template needs; run_live
    # then feeds the live stream. --head_ckpt names the head workspace.
    workspace = cfg.head_ckpt or cfg.workspace
    session = InferenceSession(cfg.replace(asr=False), device=device)
    try:
        session.load_model(cfg.path, workspace)
    except FileNotFoundError as e:
        raise SystemExit(f"no head checkpoint in {workspace!r} — --asr "
                         f"renders from trained weights only ({e})")
    ds = session.ds

    chunks = (wav_chunk_stream(cfg.asr_wav) if cfg.asr_wav
              else mic_chunk_stream())
    if cfg.asr_play:
        from .serving.asr import play_through

        chunks = play_through(chunks)
    asr = None   # the CTC object (None on the hubert path)
    if cfg.asr_model == "hubert":
        from .audio.hubert import HubertFeatureExtractor, HubertStreamer

        feature_stream = HubertStreamer(HubertFeatureExtractor(
            device=session.device)).feature_stream(chunks)
    else:
        name = (cfg.asr_model if "/" in cfg.asr_model
                else ASR_MODEL_IDS.get(cfg.asr_model))
        if name is None:
            raise RuntimeError(
                f"--asr has no streaming CTC for "
                f"asr_model={cfg.asr_model!r} (deepspeech features come "
                "from the offline tool; use --asr_model esperanto, hubert, "
                "or a HuggingFace CTC id)")
        asr = StreamingASR(asr_feature_dim(name), asr_model=name,
                           save_feats=True, left=cfg.l, mid=cfg.m,
                           right=cfg.r, device=session.device)
        feature_stream = asr.feature_rows(chunks)
    out = os.path.join(cfg.workspace, "results")
    os.makedirs(out, exist_ok=True)
    if shutil.which("ffmpeg"):
        out_path = os.path.join(out, "asr_live.mp4")
        sink = make_sink("mp4", ds.W, ds.H, fps=25, path=out_path,
                         audio_path=cfg.asr_wav)
    else:
        out_path = os.path.join(out, "asr_live.raw")
        sink = make_sink("raw", ds.W, ds.H, path=out_path)
    collected = []
    if cfg.asr_save_feats and asr is None:
        # the hubert path has no CTC accumulator: tee the stream
        def tee(stream):
            for f in stream:
                collected.append(np.asarray(f, np.float32))
                yield f

        feature_stream = tee(feature_stream)
    n, dt = session.run_live(feature_stream, sink)
    feats_path = None
    if cfg.asr_save_feats:
        # the training-layout unfold next to the wav (asr.py:236-250)
        if asr is not None and asr.all_feats:
            feats = asr.unfolded_features()
        elif collected:
            feats = np.concatenate(collected, axis=0)
        else:
            feats = None
        if feats is None:
            print("[WARN] --asr_save_feats: stream produced no features "
                  "(audio shorter than the ASR warm-up?) — nothing saved")
        else:
            feats_path = (os.path.splitext(cfg.asr_wav)[0] + ".npy"
                          if cfg.asr_wav
                          else os.path.join(out, "asr_feats.npy"))
            np.save(feats_path, feats)
            print(f"[INFO] asr features saved to {feats_path}")
    print(f"[INFO] asr live: {n} frames in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} FPS) -> {out_path}")
    return {"frames": n, "seconds": dt, "out": out_path,
            "feats": feats_path}


def run_test(cfg: Config, device=None) -> None:
    """Offline rendering of every frame of a dataset split from the EMA
    weights (--head_ckpt names the head's workspace, --torso composites
    <workspace>_torso's torso): the JAX CLI's plan (resolve_march_plan
    over the refined poses, the bucket plan, the eval and stage-2
    budgets; run_test has no rebuild loop, so an overflow only warns),
    each frame through the path it picks (the 2x2-block path, the per-ray
    compact render, or render_rays at cascade > 1), PNGs under
    <workspace>/results, result.mp4 when ffmpeg is present, and [metric]
    lines (PSNR, LPIPS, LMD) when the split has ground truth."""
    from .data.provider import NeRFDataset
    from .models.nerf import make_fused_apply
    from .ops.march2 import (build_inference_tables, bucket_short_budget,
                             ensure_variant_tables, measure_bucket_plan,
                             needed_variant_tables, resolve_march_plan)
    from .render.renderer import (field_outputs, render_rays,
                                  render_rays_compact,
                                  render_rays_compact_blocks, run_torso)
    from .train.metrics import LMDMeter, LPIPSMeter, PSNRMeter
    from .train.optim import HeadOptimizer
    from .train.trainer import Trainer, TrainState
    from .utils.device import resolve_device
    from .utils.pose import camera_refinement
    from .utils.rays import get_bg_coords, get_rays

    dev = resolve_device(device)
    head_cfg = cfg.replace(torso=False) if cfg.torso else cfg
    ds = NeRFDataset(head_cfg, type="train" if cfg.test_train else "test")
    ds.training = False
    if ds.aud_features is None:
        raise SystemExit("run_test has no audio features (asr mode?): pass "
                         "--aud <features.npy>")
    settings, occ, field = _build_world(head_cfg, ds, dev)
    opt = HeadOptimizer(field.named_parameters(), cfg.lr, cfg.lr_net,
                        cfg.iters)
    state = TrainState.create(field, opt)
    if cfg.head_ckpt:
        # checked before a Trainer makes the directory
        if not os.path.isdir(os.path.join(cfg.head_ckpt, "checkpoints")):
            raise SystemExit(
                f"--head_ckpt {cfg.head_ckpt!r}: no checkpoints/ dir")
        state, occ, resumed = Trainer(cfg.head_ckpt).load_checkpoint(
            state, occ)
        if not resumed:
            raise SystemExit(
                f"--head_ckpt {cfg.head_ckpt!r}: no checkpoint found")
    trainer = Trainer(cfg.workspace)
    if not cfg.head_ckpt:
        state, occ, resumed = trainer.load_checkpoint(state, occ)
    trainer.log(f"[INFO] test: {len(ds)} frames, ckpt resumed={resumed}")

    torso = tpacked = None
    if cfg.torso:
        torso_ws = _torso_workspace(cfg.workspace)
        torso = _make_torso(cfg, dev)
        t_state = TrainState.create(torso, HeadOptimizer(
            torso.named_parameters(), cfg.lr, cfg.lr_net, cfg.iters))
        t_state, occ_t, t_ok = Trainer(torso_ws).load_checkpoint(t_state,
                                                                 occ)
        # only the torso grid: the torso stage's head grid is empty
        occ = occ._replace(density_grid_torso=occ_t.density_grid_torso,
                           mean_density_torso=occ_t.mean_density_torso)
        if cfg.use_ema:
            torso.load_state_dict(t_state.ema)
        torso.eval()
        tpacked = torso.bake_table(torch.float32)
        trainer.log(f"[INFO] torso ckpt ({torso_ws}) resumed={t_ok}")

    H, W = ds.H, ds.W
    budget = max(1024, int(cfg.budget_frac * H * W) // 1024 * 1024)
    bg_coords = get_bg_coords(H, W, device=dev)[0]
    use_compact = settings.cascade == 1
    if not use_compact:
        trainer.log(
            f"[INFO] bound={cfg.bound} -> cascade={settings.cascade} > 1: "
            "the compact/block fast path supports cascade == 1 only; "
            "rendering through the exhaustive marcher (render_rays) — "
            "slower, sample-identical")
    # inference runs from the EMA weights
    if cfg.use_ema:
        field.load_state_dict(state.ema)
    field.eval()
    isettings = dataclasses.replace(
        settings, max_steps=cfg.infer_samples or settings.max_steps)
    packed = field.bake_tables(torch.bfloat16 if cfg.infer_table_bf16
                               else torch.float32)
    tables = build_inference_tables(occ.occ, settings.bound, variants=())
    k2 = cfg.infer_window_candidates
    march_group = cfg.infer_march_group
    march_variant = cfg.infer_march_variant
    use_blocks = (use_compact and cfg.infer_block == 2 and H % 2 == 0
                  and W % 2 == 0 and budget % 4 == 0)
    train_camera = cfg.train_camera and hasattr(field, "camera_dT")
    # the measured plan sees the rays the frames cast: the learned
    # refinement folded into the poses (R' = dR^T R, t' = t + dT)
    measure_poses = ds.poses
    if train_camera:
        with torch.no_grad():
            n = len(ds.poses)
            dR, dT = camera_refinement(field.camera_dR, field.camera_dT,
                                       torch.arange(n, device=dev))
        measure_poses = np.array(ds.poses, copy=True)
        measure_poses[:, :3, :3] = np.einsum(
            "nij,nik->njk", dR.cpu().numpy(), measure_poses[:, :3, :3])
        measure_poses[:, :3, 3] += dT.cpu().numpy()
    use_prepass = False
    if use_compact:
        k2, march_group, march_variant = resolve_march_plan(
            isettings, tables.z_lo, tables.z_hi, measure_poses,
            ds.intrinsics, H, W, k2_override=k2,
            march_group=march_group if use_blocks else 1,
            march_variant=march_variant, log=trainer.log,
            measure="block" if use_blocks else "ray")
        use_prepass = (use_blocks and march_group == 2
                       and cfg.infer_march_prepass)
        tables = ensure_variant_tables(tables, occ.occ, needed_variant_tables(
            march_group, march_variant, prepass=use_prepass))
    k2 = k2 or None
    march_bucket = None
    if use_prepass and cfg.infer_march_bucket and k2:
        k2s, n_short, _, _ = measure_bucket_plan(
            isettings, tables.z_lo, tables.z_hi, tables.col_dilwords,
            measure_poses, ds.intrinsics, H, W, k2, log=trainer.log)
        if k2s:
            bs = bucket_short_budget(n_short, budget, 1024)
            if bs:
                march_bucket = (k2s, bs)
    long_budget = budget - march_bucket[1] if march_bucket else 0
    s2_budget = max(1024, int(budget * cfg.infer_stage2_frac) // 1024 * 1024)
    eval_budget = 0
    if use_blocks and cfg.infer_eval_frac > 0:
        eval_budget = min(budget, max(
            1024, int(budget * cfg.infer_eval_frac) // 1024 * 1024))
    aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    bg_full = torch.as_tensor(ds.bg_img.reshape(-1, 3), device=dev)
    ind_code = field.individual_codes[0].detach() if cfg.ind_dim > 0 else None
    fixed_eye = (cfg.fix_eye if cfg.exp_eye and cfg.fix_eye >= 0 else None)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    @torch.no_grad()
    def render_frame(b):
        pose = torch.as_tensor(b["pose"], device=dev)
        rays = get_rays(pose[None], ds.intrinsics, H, W)
        origin = rays["rays_o"][0, 0]
        rays_d = rays["rays_d"][0]
        if train_camera:
            dR, dT = camera_refinement(field.camera_dR.detach(),
                                       field.camera_dT.detach(),
                                       int(b["index"]))
            origin = origin + dT
            rays_d = rays_d @ dR
        enc_a = field.encode_audio(torch.as_tensor(b["auds"], device=dev))
        eye = torch.as_tensor(
            [fixed_eye] if fixed_eye is not None else b["eye"],
            dtype=torch.float32, device=dev)
        bg = bg_full
        if torso is not None:
            ct = (torso.individual_codes_torso[0]
                  if cfg.ind_dim_torso > 0 else None)
            bg = run_torso(lambda x, p, c: torso(x, p, c, tpacked),
                           settings, occ, bg_coords, pose, ct,
                           bg_full)["bg_color"]
        apply = make_fused_apply(field, packed, enc_a, ind_code, eye)
        if not use_compact:
            out = render_rays(field_outputs(apply), isettings, occ,
                              origin.expand(rays_d.shape), rays_d, bg,
                              aabb=aabb)
        elif use_blocks:
            out = render_rays_compact_blocks(
                apply, isettings, origin, rays_d, H, W, bg, budget=budget,
                tables=tables, window_candidates=k2,
                stage_split=cfg.infer_stage_split, stage2_budget=s2_budget,
                march_group=march_group,
                march_variant="nb5wp",
                eval_budget=eval_budget, march_bucket=march_bucket,
                march_prepass=use_prepass, aabb=aabb)
        else:
            out = render_rays_compact(
                apply, isettings, origin.expand(rays_d.shape), rays_d, bg,
                budget=budget, tables=tables, window_candidates=k2,
                minimal=True, stage_split=cfg.infer_stage_split,
                stage2_budget=s2_budget, aabb=aabb)
        return (out["image"].reshape(H, W, 3),
                *(out.get(k, zero) for k in ("n_active", "n_stage2",
                                             "n_winmax", "n_real",
                                             "n_long")))

    out_dir = os.path.join(cfg.workspace, "results")
    os.makedirs(out_dir, exist_ok=True)
    meters = ([PSNRMeter(), LPIPSMeter(device=dev), LMDMeter()]
              if ds.has_gt else [])
    warned = set()

    def warn_once(key, msg):
        if key not in warned:
            trainer.log(msg)
            warned.add(key)

    def consume(i, img_dev, n_act, n_s2, n_wm, n_rl, n_lg, gt):
        n_act, n_s2, n_wm, n_rl, n_lg = (int(v) for v in (n_act, n_s2, n_wm,
                                                          n_rl, n_lg))
        if march_bucket and n_lg > long_budget:
            warn_once("long", f"[WARN] frame {i}: {n_lg} long-bucket rays "
                      f"exceed the long budget {long_budget}; overflow "
                      "rendered as background (raise --budget_frac)")
        img = img_dev.cpu().numpy()
        if n_act > budget:
            warn_once("budget", f"[WARN] frame {i}: {n_act} active rays "
                      f"exceed budget {budget}; overflow rendered as "
                      "background (raise --budget_frac)")
        if n_s2 > s2_budget:
            warn_once("s2", f"[WARN] frame {i}: {n_s2} stage-2 survivors "
                      f"exceed budget {s2_budget}; overflow rays truncate "
                      "at the split (raise --infer_stage2_frac)")
        if k2 and n_wm > k2:
            warn_once("k2", f"[WARN] frame {i}: a window needs {n_wm} "
                      f"march candidates > K2={k2}; truncated rays lose "
                      "far-side samples (raise --infer_window_candidates "
                      "or use 0 = measured)")
        if eval_budget and n_rl > eval_budget:
            warn_once("eval", f"[WARN] frame {i}: {n_rl} real-sample rays "
                      f"exceed eval budget {eval_budget}; overflow rendered "
                      "as background (raise --infer_eval_frac)")
        _save_image(img, os.path.join(out_dir, f"{i:05d}.png"))
        for m in meters:
            m.update(img, gt)

    # frame i + 1 is queued on the device before frame i is read back
    t0 = time.time()
    pending = None
    for i in range(len(ds)):
        b = ds.frame(i)
        res = render_frame(b)
        if pending is not None:
            consume(*pending)
        pending = (i, *res, b["image"] if ds.has_gt else None)
    if pending is not None:
        consume(*pending)
    fps = len(ds) / (time.time() - t0)
    trainer.log(f"[INFO] rendered {len(ds)} frames at {fps:.2f} FPS")
    for m in meters:
        trainer.log("[metric] " + m.report())
    _frames_to_video(out_dir, os.path.join(cfg.workspace, "result.mp4"),
                     fps=25, log=trainer.log)


def _save_image(img, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(img)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def _frames_to_video(frame_dir: str, out_path: str, fps: int = 25,
                     log=print) -> None:
    if shutil.which("ffmpeg") is None:
        log(f"[WARN] ffmpeg not found; frames left in {frame_dir}")
        return
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
           os.path.join(frame_dir, "%05d.png"), "-c:v", "libx264",
           "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    log(f"[INFO] wrote {out_path}")


def main(argv=None) -> None:
    cfg, device = parse_args(argv)
    os.makedirs(cfg.workspace, exist_ok=True)
    if cfg.gui:
        print("[INFO] --gui: the browser UI is the port's viewer — run "
              "`python -m lzzx_nerf_tpu_torch.serving.webapi --port 7860` "
              "and open http://127.0.0.1:7860/")
    if cfg.save_mesh:
        run_save_mesh(cfg, device)
    elif cfg.asr:
        run_asr_live(cfg, device)
    elif cfg.test:
        run_test(cfg, device)
    else:
        run_train(cfg, device)


if __name__ == "__main__":
    main()
