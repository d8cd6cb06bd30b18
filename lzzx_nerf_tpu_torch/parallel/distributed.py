"""Process groups (port of lzzx_nerf_tpu/parallel/distributed.py).

The JAX package joins a multi-host run from JAX_COORDINATOR_ADDRESS; the
port joins a torch.distributed group from torchrun's environment
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), or starts its
ranks itself (launch: one process per rank, torch.multiprocessing, the
ranks meeting through a file under a temporary directory, so no port is
chosen). The backend is NCCL for ranks on GPUs and gloo for ranks on the
CPU; nothing falls back from one to the other.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for a CUDA run, else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(device="cuda") -> bool:
    """Join the group torchrun's environment describes (the counterpart of
    JAX_COORDINATOR_ADDRESS); a no-op without that environment. Returns
    True when running distributed."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return True


def is_coordinator() -> bool:
    """Rank 0 (or no group): the rank that logs and writes checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_to_global(mesh, batch: Dict, sharded_keys=()) -> Dict:
    """A rank's batch as the step's global batch. The trainer's batch is a
    replicated full frame (every rank loads the same frame and samples the
    same rays), so every key is put on the rank's device as it is; a key
    in `sharded_keys` holds this rank's leading slice and is gathered from
    every rank in rank order (none in the recipe)."""
    from .mesh import data_sharding

    ds = data_sharding(mesh, mesh.axis_name)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        v = v.to(mesh.device)
        out[k] = ds.gather_rows(v).detach() if k in sharded_keys else v
    return out


def _rank_main(rank: int, fn: Callable, world: int, init_file: str,
               device: str, args: tuple, out_dir: str,
               threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev),
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence = (),
           device: str = "cpu", threads: Optional[int] = None) -> List[Any]:
    """Run fn(*args) as ranks 0..world-1 of one group, one process each
    (torch.multiprocessing's spawn), rank r on cuda:r (or the CPU for
    device "cpu"); the ranks meet through a file in a temporary
    directory. fn must be importable (a module-level function) and its
    return value picklable. Returns every rank's return value in rank
    order; raises when a rank fails."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="lzzx_dist_")
    try:
        mp.spawn(_rank_main, args=(fn, world, os.path.join(tmp, "init"),
                                   str(device), tuple(args), tmp, threads),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
