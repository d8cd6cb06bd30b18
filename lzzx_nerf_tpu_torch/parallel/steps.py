"""Data-parallel head steps from a picklable spec: what a rank of
parallel.distributed.launch runs to hold the data-parallel step against
another run of it (the CPU parity tests at world size 2 over gloo,
chip_smoke.py's card step at world size 1).

spec: {"device": "cpu" | "cuda", "field": NeRFField kwargs, "state": the
field's state_dict as numpy arrays, "settings": RenderSettings kwargs,
"occ": OccupancyState fields as numpy arrays, "batch": a frame (numpy
arrays, "index" an int), "common": make_train_step kwargs, "cases": [{
"step": the state's step, "kw": more make_train_step kwargs, "draws":
numpy draws (global, as a single-device step takes them), "lpips": an
LPIPS npz path, "random" for the fixed-seed backbone, or None, "opt":
(lr, lr_net, iters)}]}. Each case starts from the spec's state.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch


def _digest(tensors: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def head_steps(spec: Dict) -> List[Dict]:
    """Run every case of `spec` as one data-parallel step over the
    default process group -> per case: the metrics (Python numbers), the
    digest of the parameters, EMA and second moments after the step (equal
    on every rank when the replicated state agrees bit for bit), and on
    rank 0 the gradients (summed over the ranks) and the updated
    parameters as numpy arrays."""
    import torch.distributed as dist

    from ..models.nerf import NeRFField
    from ..render.state import OccupancyState, RenderSettings
    from ..train import lpips as lpips_mod
    from ..train.optim import HeadOptimizer
    from ..train.trainer import TrainState, make_train_step
    from . import data_sharding, make_mesh
    from .distributed import rank_device

    dev = rank_device(spec["device"])
    mesh = make_mesh("data", [dev], group=dist.group.WORLD)
    sh = data_sharding(mesh)
    settings = RenderSettings(**spec["settings"])
    occ = OccupancyState(**{k: torch.as_tensor(np.asarray(v), device=dev)
                            for k, v in spec["occ"].items()})
    batch = {k: (int(v) if k == "index"
                 else torch.as_tensor(np.array(v), device=dev))
             for k, v in spec["batch"].items()}
    out = []
    for case in spec["cases"]:
        field = NeRFField(**spec["field"]).to(dev)
        field.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in spec["state"].items()})
        lr, lr_net, iters = case.get("opt", (1e-2, 1e-3, 100))
        st = TrainState.create(field, HeadOptimizer(
            field.named_parameters(), lr, lr_net, iters))
        st.step = case["step"]
        lp = case.get("lpips")
        if lp == "random":
            lp = lpips_mod.random_params(device=dev)
        elif lp is not None:
            lp = lpips_mod.load_weights(lp, dev)
        fn = make_train_step(field, settings, data_sharding=sh,
                             lpips_params=lp,
                             **{**spec["common"], **case.get("kw", {})})
        draws = {k: torch.as_tensor(np.asarray(v))
                 for k, v in case.get("draws", {}).items()}
        m = fn(st, occ, batch, draws=draws)
        res = {"metrics": {k: (v.item() if isinstance(v, torch.Tensor)
                               else v) for k, v in m.items()},
               "digest": _digest({
                   **{f"p/{n}": p for n, p in field.named_parameters()},
                   **{f"e/{n}": e for n, e in st.ema.items()},
                   **{f"nu/{n}": v for n, v in
                      st.opt.state_dict()["nu"].items()}})}
        if sh.rank == 0:
            res["grads"] = {n: (p.grad.detach().cpu().numpy()
                                if p.grad is not None else
                                np.zeros(tuple(p.shape), np.float32))
                            for n, p in field.named_parameters()}
            res["params"] = {n: p.detach().cpu().numpy()
                             for n, p in field.named_parameters()}
        out.append(res)
    return out
