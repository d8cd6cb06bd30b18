"""Import a reference (LZZX-NeRF / ER-NeRF) checkpoint into a workspace of
the port's CLI (the port of scripts/import_reference_ckpt.py, same
options plus --device):

    python -m lzzx_nerf_tpu_torch.tools.import_reference_ckpt \\
        --ckpt trial_obama/checkpoints/ngp_ep0035.pth \\
        --data data/obama --workspace trial_obama_port \\
        [--torso-ckpt trial_obama_torso/checkpoints/ngp_ep0028.pth]

then render, train further, or serve it like a workspace the port trained:

    python -m lzzx_nerf_tpu_torch.cli data/obama \\
        --workspace trial_obama_port --encoder hash --test 1 --test_train 1
    python -m lzzx_nerf_tpu_torch.serving.webapi --port 7860

What it does:
- converts the ['model'] state dict (utils/convert.py) over a freshly
  initialised NeRFField(encoder="hash"); the EMA weights are the imported
  ones (the reference's 'best' checkpoints are its EMA weights);
- imports the density grid when the checkpoint carries one: the
  reference's buffers are Morton-ordered [CAS, H^3], de-Mortonised here
  into the natural-order occupancy state (ops/morton.morton_perm), with
  the occupancy dg > min(density_thresh, mean_density) (the reference's
  grid already marks the cells no camera saw -1). A checkpoint without a
  grid keeps the cells no training camera sees marked and says so;
- writes the port CLI's checkpoint under <workspace>/checkpoints (and the
  torso's under <workspace>_torso, TorsoField(encoder="tiled"), with the
  torso run's own mean_density_torso) and appends the Config, encoder
  "hash", as the last line of <workspace>/opt.txt, which the CLI and the
  serving session adopt.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def dem_morton(grid_flat: np.ndarray, H: int) -> np.ndarray:
    """[CAS, H^3] Morton-ordered -> [CAS, H, H, H] natural xyz order."""
    from ..ops.morton import morton_perm

    return grid_flat[:, morton_perm(H)].reshape(-1, H, H, H)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--torso-ckpt", default=None)
    ap.add_argument("--asr_model", default="hubert")
    ap.add_argument("--grid_size", type=int, default=128,
                    help="must match the original training run")
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu without a GPU")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Write the workspace; returns {"workspace", "torso_workspace" or
    None, "occupied", "missing"}."""
    args = parse_args(argv)
    from ..cli import _build_world, _make_torso
    from ..config import Config
    from ..data.provider import NeRFDataset
    from ..train.optim import HeadOptimizer
    from ..train.trainer import Trainer, TrainState
    from ..utils.convert import (convert_reference_state_dict,
                                 convert_reference_torso)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    cfg = Config(path=args.data, workspace=args.workspace,
                 asr_model=args.asr_model, encoder="hash",
                 grid_size=args.grid_size, bound=args.bound)
    if "individual_codes" in sd:
        # the checkpoint's own dims, so every later reader builds a field
        # of its shapes (opt.txt carries them)
        n, d = sd["individual_codes"].shape
        cfg = cfg.replace(ind_num=int(n), ind_dim=int(d))
    # the model's branches: the eye net of exp_eye, the label embedding of
    # emb (opt.txt carries both)
    cfg = cfg.replace(exp_eye="eye_att_net.net.0.weight" in sd,
                      emb="embedding.weight" in sd)
    ds = NeRFDataset(cfg, type="train")
    settings, occ, field = _build_world(cfg, ds, dev)
    converted = convert_reference_state_dict(sd)
    own = field.state_dict()
    missing = [k for k in own if k not in converted
               and k not in ("camera_dR", "camera_dT")]
    field.load_state_dict({**own, **converted})
    if missing:
        log(f"[note] kept fresh-init for params absent from the "
            f"checkpoint: {missing}")

    H = settings.grid_size
    occupied = None
    if "density_grid" in sd:
        dg = torch.as_tensor(sd["density_grid"]).float().numpy()
        if dg.size % (H ** 3) or dg.size // (H ** 3) < 1:
            raise SystemExit(
                f"[ERROR] checkpoint density grid has {dg.size} cells, not "
                f"a [CAS, {H}^3] buffer — pass --grid_size to match the "
                "original training run")
        if dg.size // (H ** 3) != settings.cascade:
            raise SystemExit(
                f"[ERROR] checkpoint density grid has {dg.size // H ** 3} "
                f"cascade(s) but --bound {args.bound} implies "
                f"{settings.cascade} — pass --bound to match the original "
                "run")
        dg = dem_morton(dg.reshape(settings.cascade, -1), H)
        mean_density = float(ckpt.get("mean_density", dg.mean()))
        thresh = min(cfg.density_thresh, mean_density)
        occ = occ._replace(
            density_grid=torch.as_tensor(dg, device=dev),
            occ=torch.as_tensor(dg > thresh, device=dev),
            mean_density=torch.tensor(mean_density, dtype=torch.float32,
                                      device=dev))
        occupied = int(np.sum(dg > thresh))
        log(f"[ok] density grid imported ({occupied} occupied cells, "
            f"mean_density={mean_density:.3f})")
    else:
        log("[note] checkpoint has no density grid ('best'-style save "
            "drops it): starting from the cells no training camera sees "
            "marked untrained — run a few --iters so the grid refresh "
            "refines it, or --test with --budget_frac 1.0")
    if "mean_density_torso" in ckpt:
        occ = occ._replace(mean_density_torso=torch.tensor(
            float(ckpt["mean_density_torso"]), dtype=torch.float32,
            device=dev))

    opt = HeadOptimizer(field.named_parameters(), cfg.lr, cfg.lr_net,
                        cfg.iters, log=log)
    state = TrainState.create(field, opt)      # EMA = the imported weights
    state.step = int(ckpt.get("global_step", 0))
    Trainer(args.workspace).save_checkpoint(state, occ)
    # the serving session and the CLI adopt the LAST line of opt.txt (one
    # JSON document per line)
    with open(os.path.join(args.workspace, "opt.txt"), "a") as f:
        f.write(cfg.to_json(indent=None) + "\n")
    log(f"[ok] head checkpoint written to {args.workspace}\n"
        f"     evaluate: python -m lzzx_nerf_tpu_torch.cli {args.data} "
        f"--workspace {args.workspace} --encoder hash "
        f"--grid_size {cfg.grid_size} --ind_num {cfg.ind_num} "
        f"--ind_dim {cfg.ind_dim} --asr_model {cfg.asr_model} "
        f"--test 1 --test_train 1")

    tws = None
    if args.torso_ckpt:
        tckpt = torch.load(args.torso_ckpt, map_location="cpu",
                           weights_only=False)
        tsd = tckpt.get("model", tckpt)
        torso = _make_torso(cfg, dev)                 # tiled
        tconv = convert_reference_torso(tsd)
        torso.load_state_dict({**torso.state_dict(), **tconv})
        occ_t = occ
        if "density_grid_torso" in tsd:
            g = torch.as_tensor(tsd["density_grid_torso"]).float()
            occ_t = occ_t._replace(density_grid_torso=g.reshape(H, H).to(dev))
        # the torso run's own checkpoint carries its mean (the head's is
        # 0 unless head and torso trained together)
        if "mean_density_torso" in tckpt:
            occ_t = occ_t._replace(mean_density_torso=torch.tensor(
                float(tckpt["mean_density_torso"]), dtype=torch.float32,
                device=dev))
        t_state = TrainState.create(torso, HeadOptimizer(
            torso.named_parameters(), cfg.lr, cfg.lr_net, cfg.iters,
            log=log))
        tws = args.workspace.rstrip("/") + "_torso"
        Trainer(tws).save_checkpoint(t_state, occ_t)
        log(f"[ok] torso checkpoint written to {tws} (encoder=tiled; "
            "--encoder hash at test and serving time takes it)")
    return {"workspace": args.workspace, "torso_workspace": tws,
            "occupied": occupied, "missing": missing}


if __name__ == "__main__":
    main()
