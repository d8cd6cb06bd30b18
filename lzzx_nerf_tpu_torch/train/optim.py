"""The training optimizer (port of lzzx_nerf_tpu/train/optim.py): AdamW
per parameter group with the reference's hyperparameters, an exponential
learning-rate schedule, and optax.apply_if_finite's skip of non-finite
steps. The head, the lips finetune (finetune_lips: decay 0.05 per `iters`)
and the torso stage (its torso_encoder_l* tables are grid, the rest net)
each run one.

Groups (param_label_fn, the JAX package's rule):
  grid  (triplane tables):  lr,          weight decay 0.01
  att   (audio_att_net):    lr_net * 5,  weight decay 1e-4
  net   (everything else, the label embedding of emb included):
                            lr_net,      weight decay 0
  camera (camera_dR/dT):    1e-5,        weight decay 0, no schedule
All groups: b1 = 0, b2 = 0.99, eps 1e-8, decay decoupled as in
optax.adamw, lr(count) = base * rate ** (count / iters), unclamped, with
rate 0.5 (0.05 for the lips finetune).

The update runs in optax's order of operations: mu = g (b1 = 0 leaves no
first moment to keep), nu = b2 nu +
(1 - b2) g², u = mu / (sqrt(nu / (1 - b2^count)) + eps), u += wd * p,
p += -lr * u. A step whose gradients hold any inf or nan changes no
parameter, no moment and no schedule count (the schedule counts inside the
skipped state, so the count is a tensor the skip holds back, not a
per-iteration scheduler); after more than max_consecutive_errors
consecutive bad steps the update applies anyway, as optax does. The
decision is made on the device: a step needs no host sync. poll() reads
the counters to the host and logs the skips since the last poll, which is
the one thing this optimizer adds to optax's behaviour."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Tuple

import torch

GRID_TABLES = ("encoder_xy", "encoder_yz", "encoder_xz", "torso_encoder")
B2 = 0.99
EPS = 1e-8


def param_label_fn(name: str) -> str:
    """A parameter's group from its state_dict name (the JAX package's
    rule over the flax path)."""
    parts = set(name.split("."))
    if any(n.startswith("encoder_") or n.startswith("torso_encoder")
           for n in parts):
        return "grid"
    if "audio_att_net" in parts:
        return "att"
    if parts & {"camera_dR", "camera_dT"}:
        return "camera"
    return "net"


def lr_decay_rate(finetune_lips: bool) -> float:
    """Per-`iters` exponential decay: 0.5 (0.05 for the lips finetune)."""
    return 0.05 if finetune_lips else 0.5


class HeadOptimizer:
    """AdamW groups + the non-finite skip over named parameters."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr: float = 1e-2, lr_net: float = 1e-3,
                 iters: int = 200_000, finetune_lips: bool = False,
                 max_consecutive_errors: int = 100,
                 log: Callable[[str], None] = print):
        self.iters = iters
        self.decay_rate = lr_decay_rate(finetune_lips)
        self.max_consecutive_errors = max_consecutive_errors
        self.log = log
        hyper = {"grid": (lr, 0.01), "att": (lr_net * 5, 1e-4),
                 "net": (lr_net, 0.0), "camera": (1e-5, 0.0)}
        self.groups: Dict[str, dict] = {}
        self.names: List[str] = []
        dev = None
        for name, p in named_params:
            label = param_label_fn(name)
            g = self.groups.setdefault(label, {
                "lr": hyper[label][0], "wd": hyper[label][1],
                "names": [], "params": [], "nu": []})
            g["names"].append(name)
            g["params"].append(p)
            g["nu"].append(torch.zeros_like(p))
            self.names.append(name)
            dev = p.device
        # optax keeps one count per group; every group steps together, so
        # one count serves all
        z = torch.zeros((), dtype=torch.int32, device=dev)
        self.count = z.clone()
        self.notfinite_count = z.clone()
        self.total_notfinite = z.clone()
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        # steps whose non-finite update applied after the backstop
        self.total_forced = z.clone()
        self._polled = (0, 0)

    def lr_factor(self, count=None) -> torch.Tensor:
        c = self.count if count is None else count
        return torch.pow(self.decay_rate, c.to(torch.float32) / self.iters)

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' .grad (a missing .grad counts
        as zeros)."""
        grads = {}
        finite = []
        for g in self.groups.values():
            gs = [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in g["params"]]
            grads[id(g)] = gs
            finite += [torch.isfinite(x).all() for x in gs]
        isfinite = torch.stack(finite).all()
        self.notfinite_count = torch.where(
            isfinite, torch.zeros_like(self.notfinite_count),
            self.notfinite_count + 1)
        apply = isfinite | (self.notfinite_count
                            > self.max_consecutive_errors)
        self.total_notfinite = torch.where(
            isfinite, self.total_notfinite, self.total_notfinite + 1)
        self.total_forced = self.total_forced + (apply & ~isfinite).to(
            torch.int32)
        self.last_finite = isfinite
        count_inc = self.count + 1
        # float32 like optax: b2 ** count and base * rate ** (count / iters)
        bc = 1.0 - torch.pow(B2, count_inc.to(torch.float32))
        lr_f = self.lr_factor(self.count)
        for label, g in self.groups.items():
            # the camera group's learning rate is constant (optax.adamw
            # with a float rate)
            neg_lr = (-g["lr"] if label == "camera"
                      else -(lr_f * g["lr"]))
            for p, x, nu in zip(g["params"], grads[id(g)], g["nu"]):
                nu_new = (1.0 - B2) * (x * x) + B2 * nu
                u = x / (torch.sqrt(nu_new / bc) + EPS)
                u = u + g["wd"] * p
                p_new = p + neg_lr * u
                p.copy_(torch.where(apply, p_new, p))
                nu.copy_(torch.where(apply, nu_new, nu))
        self.count = torch.where(apply, count_inc, self.count)

    def zero_grad(self) -> None:
        for g in self.groups.values():
            for p in g["params"]:
                p.grad = None

    def poll(self, it: int) -> Tuple[int, int]:
        """Read the skip counters (one host sync) and log a [WARN] line
        for steps skipped since the last poll, a louder one for non-finite
        updates the backstop applied. Returns (total_notfinite,
        consecutive)."""
        total, consec, forced = (int(x) for x in torch.stack([
            self.total_notfinite, self.notfinite_count,
            self.total_forced]).tolist())
        seen_total, seen_forced = self._polled
        if forced > seen_forced:
            self.log(f"[WARN] it {it}: {forced - seen_forced} non-finite "
                     f"update(s) APPLIED after more than "
                     f"{self.max_consecutive_errors} consecutive non-finite "
                     f"steps; the parameters may now hold inf/nan "
                     f"(total skipped {total})")
        elif total > seen_total:
            self.log(f"[WARN] it {it}: {total - seen_total} step(s) with "
                     f"non-finite gradients skipped since the last check "
                     f"({consec} consecutive, {total} in all); parameters, "
                     "moments and the schedule did not move")
        self._polled = (total, forced)
        return total, consec

    def state_dict(self) -> dict:
        return {"count": self.count, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "nu": {n: nu for g in self.groups.values()
                       for n, nu in zip(g["names"], g["nu"])}}

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping) -> None:
        """Restore the counters and second moments of state_dict() (values
        may be numpy arrays or tensors; each moment keeps its device)."""
        for key in ("count", "notfinite_count", "total_notfinite"):
            getattr(self, key).fill_(int(sd[key]))
        missing = set(self.names) - set(sd["nu"])
        if missing:
            raise KeyError(f"no second moment for {sorted(missing)}")
        for g in self.groups.values():
            for n, nu in zip(g["names"], g["nu"]):
                nu.copy_(torch.as_tensor(sd["nu"][n]))
