"""A 1-D device mesh and its shardings (port of
lzzx_nerf_tpu/parallel/mesh.py).

A mesh is an ordered list of devices along one axis plus the process
group that spans them. Two kinds exist:

- one process drives every device (group None): the frame-parallel
  serving session renders whole frames on each of them;
- one process per device, the ranks of a torch.distributed group
  (data-parallel training): member i is rank i, and `devices` lists every
  rank's device in rank order.

Parameters are replicated; the per-step ray batch is sharded along the
mesh axis, ray i at [i // n_local, i % n_local] (rank i // n_local holds
a contiguous slice), as the JAX package's NamedSharding(mesh, P("data"))
lays it out. A data-parallel step gathers the per-ray outputs of every
rank for the loss (gather_rows) and sums the ranks' gradients
(all_reduce_grads).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        """This process's member (0 when one process drives the mesh)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def device(self) -> torch.device:
        """The device this process computes on: its rank's, or the first
        of a single-process mesh."""
        return self.devices[self.rank]


def make_mesh(axis_name: str = "data",
              devices: Optional[Sequence] = None, group: Any = None) -> Mesh:
    """A mesh along `axis_name`. Without a group: over `devices` (default
    every visible GPU), all driven by this process. With a process group:
    `devices` is this rank's one device, and the mesh lists every rank's
    device in rank order (gathered from the group)."""
    if group is None:
        devs = tuple(torch.device(d) for d in (
            devices if devices is not None else
            [f"cuda:{i}" for i in range(torch.cuda.device_count())]))
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devs, axis_name)
    mine = list(devices) if devices is not None else []
    if len(mine) != 1:
        raise ValueError("a rank of a process group drives one device: "
                         f"got {mine}")
    names = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, str(torch.device(mine[0])), group=group)
    return Mesh(tuple(torch.device(n) for n in names), axis_name, group)


@dataclass(frozen=True)
class Replicated:
    """Every member holds the whole tensor."""
    mesh: Mesh

    def place(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.mesh.device)


@dataclass(frozen=True)
class DataSharding:
    """The leading (ray) axis split into mesh.size contiguous slices."""
    mesh: Mesh

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def n_local(self, n: int) -> int:
        """Rows per member; raises unless n divides by the mesh size."""
        if n % self.size:
            raise ValueError(f"num_rays {n} must divide by the "
                             f"data-parallel factor {self.size}")
        return n // self.size

    def slice(self, x: torch.Tensor, member: Optional[int] = None
              ) -> torch.Tensor:
        """Member `member`'s rows of x (default this rank's)."""
        k = self.n_local(x.shape[0])
        i = self.rank if member is None else member
        return x[i * k:(i + 1) * k]

    def place(self, x: torch.Tensor) -> torch.Tensor:
        return self.slice(x).to(self.mesh.device)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's x [n_local, ...] in rank order -> [size *
        n_local, ...], the same values on every rank. Only this rank's rows
        carry x's gradient (the others are detached copies): a loss of the
        gathered rows, computed alike on every rank, gives each rank the
        gradient of its own rows, and all_reduce_grads sums them."""
        if self.mesh.group is None:
            if self.size != 1:
                raise ValueError("gather_rows needs a process group")
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous(),
                        group=self.mesh.group)
        parts[self.rank] = x
        return torch.cat(parts)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over members of a per-rank scalar, summed in rank order
        (the same value on every rank), with this rank's gradient."""
        return self.gather_rows(x.reshape(1)).sum()

    def counts(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's integer scalar, in rank order, detached."""
        return self.gather_rows(x.detach().reshape(1))

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum the .grad of `params` over the members, in one flat
        all_reduce (a missing gradient counts as zeros, as the optimizer
        reads it)."""
        if self.mesh.group is None:
            return
        params = list(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group)
        off = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[off:off + n].view_as(g)
            off += n

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values into `tensors` on every rank (replicated state
        made bit-equal)."""
        if self.mesh.group is None:
            return
        src = dist.get_global_rank(self.mesh.group, 0)
        for t in tensors:
            dist.broadcast(t, src, group=self.mesh.group)


def data_sharding(mesh: Mesh, axis_name: str = "data") -> DataSharding:
    """Shard the leading (ray / pixel) axis across the mesh."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}")
    return DataSharding(mesh)


def replicate(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


# keys that are genuinely per-ray (leading axis = ray). Full-frame tensors
# (image [H,W,3], masks, bg_color, pose, auds) are replicated: the step
# samples pixels from them and shards the sampled rays itself.
_BATCH_SHARDED_KEYS = {"rays_o", "rays_d", "noise", "inds"}


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """A provider batch on this rank's device: per-ray arrays sharded
    along their leading axis, everything else (full frames, per-frame
    scalars) replicated."""
    ds, rep = data_sharding(mesh, axis_name), replicate(mesh)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
        elif k in _BATCH_SHARDED_KEYS and v.dim() >= 1:
            out[k] = ds.place(v)
        else:
            out[k] = rep.place(v)
    return out
