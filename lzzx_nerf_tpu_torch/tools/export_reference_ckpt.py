"""Export a workspace of the port's CLI, trained with --encoder hash, to
the reference (LZZX-NeRF / ER-NeRF) checkpoint format (the port of
scripts/export_reference_ckpt.py, same options plus --device; the inverse
of tools/import_reference_ckpt.py):

    python -m lzzx_nerf_tpu_torch.tools.export_reference_ckpt \\
        --workspace trial_obama_port --data data/obama \\
        --out ngp_from_port.pth [--torso-workspace trial_obama_port_torso]

What it does:
- reads the workspace's newest checkpoint (the architecture from the last
  line of its opt.txt) and writes its EMA weights in the reference's
  ['model'] layout (utils/convert.py; the reference's 'best' checkpoints
  are EMA weights);
- re-Mortonises the natural-order density grid into the reference's
  [CAS, H^3] buffer and packs the occupancy bitfield the way its marcher
  reads it (8 cells a byte, little bit order);
- merges the tiled torso of --torso-workspace into the same state dict
  (the reference keeps head and torso in one model) with its flat torso
  grid;
- writes mean_density, mean_density_torso and global_step beside it with
  torch.save.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def to_morton(natural: np.ndarray) -> np.ndarray:
    """[CAS, H, H, H] natural xyz order -> [CAS, H^3] Morton-ordered
    (the inverse of import_reference_ckpt.dem_morton)."""
    from ..ops.morton import morton_perm

    H = natural.shape[-1]
    flat = np.zeros((natural.shape[0], H ** 3), natural.dtype)
    flat[:, morton_perm(H)] = natural.reshape(natural.shape[0], -1)
    return flat


def adopt_opt(cfg, workspace: str, keys):
    """cfg with `keys` taken from the last line of workspace/opt.txt (one
    JSON document per line; a legacy multi-line dump is read from its last
    '{'); a missing or malformed file keeps cfg."""
    path = os.path.join(workspace, "opt.txt")
    if not os.path.exists(path):
        return cfg
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    try:
        try:
            trained = json.loads(lines[-1])
        except json.JSONDecodeError:
            trained = json.loads("{" + text.rsplit("{", 1)[-1])
        return cfg.replace(**{k: tuple(trained[k])
                              if isinstance(trained[k], list) else trained[k]
                              for k in keys if k in trained})
    except (ValueError, IndexError, TypeError, AttributeError):
        return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--torso-workspace", default=None)
    ap.add_argument("--asr_model", default="hubert")
    ap.add_argument("--grid_size", type=int, default=128)
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu without a GPU")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Write the .pth; returns the checkpoint dict it saved."""
    args = parse_args(argv)
    from ..cli import _build_world, _make_torso
    from ..config import Config
    from ..data.provider import NeRFDataset
    from ..train.optim import HeadOptimizer
    from ..train.trainer import Trainer, TrainState
    from ..utils.convert import (export_reference_state_dict,
                                 export_reference_torso)
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = Config(path=args.data, workspace=args.workspace,
                 asr_model=args.asr_model, encoder="hash",
                 grid_size=args.grid_size, bound=args.bound)
    cfg = adopt_opt(cfg, args.workspace, (
        "encoder", "grid_size", "bound", "ind_num", "ind_dim",
        "ind_dim_torso", "asr_model", "att", "exp_eye",
        # camera_dR / camera_dT live in the saved tree: the field must
        # have them to load it, though the reference has no counterpart
        "train_camera"))
    if cfg.encoder != "hash":
        raise SystemExit(
            f"workspace was trained with encoder={cfg.encoder!r}; only "
            "'hash' matches the reference parameterisation "
            "(utils/convert.py)")

    ds = NeRFDataset(cfg, type="train")
    settings, occ, field = _build_world(cfg, ds, dev)
    state = TrainState.create(field, HeadOptimizer(
        field.named_parameters(), cfg.lr, cfg.lr_net, cfg.iters, log=log))
    state, occ, resumed = Trainer(args.workspace).load_checkpoint(state, occ)
    if not resumed:
        raise SystemExit(f"no checkpoint in {args.workspace!r}")

    sd = export_reference_state_dict(state.ema)
    dg = occ.density_grid.detach().cpu().numpy().astype(np.float32)
    sd["density_grid"] = torch.from_numpy(to_morton(dg))
    occ_m = to_morton(occ.occ.detach().cpu().numpy().astype(np.uint8))
    sd["density_bitfield"] = torch.from_numpy(
        np.packbits(occ_m.reshape(-1).astype(bool), bitorder="little"))
    ckpt = {"model": sd,
            "mean_density": float(occ.mean_density),
            "mean_density_torso": float(occ.mean_density_torso),
            "global_step": int(state.step), "epoch": 0, "stats": {}}

    if args.torso_workspace:
        # the torso run records its own dims in its opt.txt
        tcfg = adopt_opt(cfg, args.torso_workspace,
                         ("ind_dim_torso", "ind_num", "torso_shrink"))
        torso = _make_torso(tcfg, dev)
        t_state = TrainState.create(torso, HeadOptimizer(
            torso.named_parameters(), cfg.lr, cfg.lr_net, cfg.iters,
            log=log))
        t_state, occ_t, t_ok = Trainer(
            args.torso_workspace).load_checkpoint(t_state, occ)
        if not t_ok:
            raise SystemExit(
                f"no torso checkpoint in {args.torso_workspace!r}")
        sd.update(export_reference_torso(t_state.ema))
        # the trained 2-D torso grid, flat like the reference's buffer
        sd["density_grid_torso"] = occ_t.density_grid_torso.detach().cpu(
            ).float().reshape(-1).clone()
        ckpt["mean_density_torso"] = float(occ_t.mean_density_torso)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(ckpt, args.out)
    log(f"[ok] reference-format checkpoint written to {args.out} "
        f"({len(sd)} tensors, step {ckpt['global_step']})")
    return ckpt


if __name__ == "__main__":
    main()
