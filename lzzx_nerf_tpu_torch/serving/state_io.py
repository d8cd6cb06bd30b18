"""Load a trained state without JAX: the one the JAX package writes
(scripts/train_production.py: trained/production_state.pkl) or the port's
(lzzx_nerf_tpu_torch/tools/train_production.py), or the newest checkpoint
of a workspace the port's CLI trained (load_workspace_state); and carry a
CLI checkpoint between the two packages (checkpoint_from_jax,
checkpoint_to_jax); and carry the 3DMM tracker's model and fit parameters
into the port (face3dmm_from_jax, track_params_from_jax).

The port's CLI checkpoint is one pickle per step,
<workspace>/checkpoints/ckpt_<step:08d>.pkl, with numpy leaves:
{"state": {"params": {"params": flax tree}, "ema_params": flax tree,
"step": int32, "opt_state": {"count", "notfinite_count",
"total_notfinite": int32, "nu": flax tree of second moments}},
"occ": {OccupancyState field: array}, "generator": {"device", "state"}
or None}. The flax trees are the JAX package's parameter paths
(params_to_jax); the first moments are not kept (the optimizer's b1 is
0, so a step never reads them).

The JAX pickle stores the trees' structure as pickled JAX PyTreeDef
objects; unpickling them would import jax. _StateUnpickler hands back an
inert stub for every jax/jaxlib class instead; the port's file has no
treedef. Either way the torso tree is rebuilt from its leaves, which are
stored in the sorted key-path order of the flax params tree
(TORSO_LEAF_PATHS for the dense torso, TORSO_TILED_LEAF_PATHS for the
tiled one, told apart by their count; flatten_paths gives the writer
that order). The head's tree carries its encoder's tables as they
are named: encoder_{xy,yz,xz}_l{0..3} (dense) or encoder_{xy,yz,xz}
(hash).
params_from_jax then maps flax Dense [in, out] and Conv [k, in, out]
kernels onto the PyTorch layouts of the port's modules (Linear [out, in],
Conv1d [out, in, k]), keyed by the modules' state_dict names.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict

import numpy as np
import torch

# the torso params tree's leaves in sorted key-path order: the dense
# torso's, and the tiled torso's (one table, torso_encoder)
_TORSO_NETS = ("torso_deform_net/net_0/kernel",
               "torso_deform_net/net_1/kernel",
               "torso_deform_net/net_2/kernel")
_TORSO_HEAD = ("torso_net/net_0/kernel", "torso_net/net_1/kernel",
               "torso_net/net_2/kernel")
TORSO_LEAF_PATHS = (
    "anchor_points", "individual_codes_torso", *_TORSO_NETS,
    "torso_encoder_l0", "torso_encoder_l1", "torso_encoder_l2",
    "torso_encoder_l3", *_TORSO_HEAD)
TORSO_TILED_LEAF_PATHS = (
    "anchor_points", "individual_codes_torso", *_TORSO_NETS,
    "torso_encoder", *_TORSO_HEAD)


def head_encoder(tree: Dict[str, Any]) -> str:
    """The encoder of a head params tree: "hash" when it holds the hash
    tables (encoder_xy), else "dense"."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return "hash" if "encoder_xy" in tree else "dense"


def torso_encoder(tree: Dict[str, Any]) -> str:
    """The encoder of a torso params tree: "tiled" when it holds the
    tiled table (torso_encoder), else "dense"."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return "tiled" if "torso_encoder" in tree else "dense"


class _JaxStub:
    """Stands in for any pickled jax/jaxlib object (the treedefs)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            return _JaxStub
        if (module.startswith("numpy._core")
                and importlib.util.find_spec("numpy._core") is None):
            # written by numpy 2 (numpy._core), read by numpy 1 (numpy.core)
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _nest(paths, leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = np.asarray(leaf)
    return tree


def flatten_paths(tree: Dict[str, Any], prefix: str = ""
                  ) -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {"a/b/c": array} (the inverse of _nest)."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flatten_paths(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def load_trained_state(path: str) -> Dict[str, Any]:
    """-> {"head": params tree, "torso": params tree or None (a state with
    no "torso_leaves": a head-only identity), "occ": {name: array},
    "meta": dict}; every leaf a numpy array. Imports no JAX."""
    with open(path, "rb") as f:
        st = _StateUnpickler(f).load()
    leaves = st.get("torso_leaves")
    # the leaf count tells the torso's encoder (12 dense, 9 tiled)
    by_count = {len(p): p for p in (TORSO_LEAF_PATHS,
                                    TORSO_TILED_LEAF_PATHS)}
    if leaves is not None and len(leaves) not in by_count:
        raise ValueError(f"{path}: {len(leaves)} torso leaves, expected "
                         f"{len(TORSO_LEAF_PATHS)} (dense) or "
                         f"{len(TORSO_TILED_LEAF_PATHS)} (tiled)")
    return {"head": st["head_ema"],
            "torso": (None if leaves is None
                      else _nest(by_count[len(leaves)], leaves)),
            "occ": {k: np.asarray(v) for k, v in st["occ"].items()},
            "meta": st["meta"]}


def params_from_jax(tree: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays) -> state_dict of the
    port's modules. Dense kernels [in, out] become Linear weights
    [out, in]; Conv kernels [k, in, out] become Conv1d weights
    [out, in, k]; the label embedding (flax nn.Embed's
    embedding/embedding [V, F]) becomes embedding.weight, as it is;
    biases and raw parameters keep their layout. A top-level "params"
    collection is unwrapped. The tree holds what the field has: no
    eye_att_net without the eye branch, no embedding without labels."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(params_from_jax(val, f"{prefix}{key}."))
            continue
        a = np.asarray(val, dtype=np.float32)
        if prefix == "embedding." and key == "embedding":
            key = "weight"
        elif key == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 3:
                a = a.transpose(2, 1, 0)
            else:
                raise ValueError(f"{prefix}kernel: unexpected rank {a.ndim}")
            key = "weight"
        out[f"{prefix}{key}"] = torch.from_numpy(np.array(a, order="C"))
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of params_from_jax: a state_dict of the port's modules ->
    flax params tree of numpy float32 arrays (Linear [out, in] -> Dense
    kernel [in, out], Conv1d [out, in, k] -> Conv kernel [k, in, out]),
    without the top-level "params" collection."""
    tree: Dict[str, Any] = {}
    for name, val in state_dict.items():
        a = val.detach().to("cpu", torch.float32).numpy()
        *parents, key = name.split(".")
        if name == "embedding.weight":
            key = "embedding"
        elif key == "weight":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 3:
                a = a.transpose(2, 1, 0)
            else:
                raise ValueError(f"{name}: unexpected rank {a.ndim}")
            key = "kernel"
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = np.array(a, order="C")
    return tree


def face3dmm_from_jax(fields: Dict[str, Any], device=None):
    """A JAX Face3DMM's fields (dataclasses.asdict, numpy arrays or None)
    -> the port's preprocess.face_tracking.Face3DMM on `device` (the
    CPU unless named): float32 tensors for the bases and means, the index
    arrays as int64 numpy arrays."""
    from ..preprocess.face_tracking import Face3DMM

    index = ("keyinds", "left_contour", "right_contour", "tris")
    out = {}
    for k, v in fields.items():
        if v is None:
            out[k] = None
        elif k in index:
            out[k] = np.asarray(v, np.int64)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32),
                                     device=device)
    return Face3DMM(**out)


def track_params_from_jax(params: Dict[str, Any], device=None
                          ) -> Dict[str, torch.Tensor]:
    """A JAX tracker fit's parameter dict (id, exp, euler, trans, focal,
    and tex / gamma after the photometric stage; numpy arrays) -> the
    port's: float32 tensors on `device`, focal a scalar. Non-array entries
    (photo_loss) are left out."""
    out = {}
    for k, v in params.items():
        if k == "photo_loss":
            continue
        a = np.asarray(v, np.float32)
        out[k] = torch.as_tensor(a.reshape(()) if k == "focal" else a,
                                 device=device)
    return out


# ---- the CLI's checkpoints ---------------------------------------------

CKPT_PREFIX = "ckpt_"


def checkpoint_steps(ckpt_dir: str):
    """The steps of the checkpoints in ckpt_dir, ascending."""
    import os

    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        stem, ext = os.path.splitext(name)
        if (ext == ".pkl" and stem.startswith(CKPT_PREFIX)
                and stem[len(CKPT_PREFIX):].isdigit()):
            steps.append(int(stem[len(CKPT_PREFIX):]))
    return sorted(steps)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    import os

    return os.path.join(ckpt_dir, f"{CKPT_PREFIX}{int(step):08d}.pkl")


def read_checkpoint(ckpt_dir: str, step=None):
    """The checkpoint at `step` (default the newest) of ckpt_dir, or None
    when there is none."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            return None
        step = steps[-1]
    with open(checkpoint_path(ckpt_dir, step), "rb") as f:
        return _StateUnpickler(f).load()


def load_workspace_state(workspace: str, use_ema: bool = True):
    """The trained state a workspace serves, in load_trained_state's form:
    <workspace>/production_state.pkl when present, else the newest CLI
    checkpoint under <workspace>/checkpoints (the EMA weights unless
    use_ema is off) with the torso of <workspace>_torso's newest
    checkpoint and its torso grid, when that workspace has one. meta then
    holds audio_dim and grid only. None when the workspace has neither."""
    import os

    prod = os.path.join(workspace, "production_state.pkl")
    if os.path.exists(prod):
        return load_trained_state(prod)
    ck = read_checkpoint(os.path.join(workspace, "checkpoints"))
    if ck is None:
        return None

    def weights(c):
        st = c["state"]
        tree = st["ema_params"] if use_ema else st["params"]["params"]
        return {k: v for k, v in tree.items()}

    head = weights(ck)
    occ = {k: np.asarray(v) for k, v in ck["occ"].items()}
    torso = None
    tck = read_checkpoint(os.path.join(workspace.rstrip("/") + "_torso",
                                       "checkpoints"))
    if tck is not None:
        torso = weights(tck)
        for k in ("density_grid_torso", "mean_density_torso"):
            occ[k] = np.asarray(tck["occ"][k])
    audio_dim = int(np.shape(head["audio_net"]["Conv_0"]["kernel"])[1])
    return {"head": head, "torso": torso, "occ": occ,
            "meta": {"audio_dim": audio_dim,
                     "grid": int(np.shape(occ["occ"])[1]),
                     "step": int(ck["state"]["step"])}}


def _is_leaf_array(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def _merge_leaves(dst: Dict[str, Any], src) -> None:
    """Copy the array leaves of a masked optax tree (MaskedNode leaves
    are skipped) into dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            _merge_leaves(dst.setdefault(k, {}), v)
            if not dst[k]:
                del dst[k]
        elif _is_leaf_array(v):
            dst[k] = np.asarray(v)


def checkpoint_from_jax(jck) -> Dict[str, Any]:
    """The JAX CLI's checkpoint ({"state": TrainState, "occ": dict} as
    its Trainer saves it, every leaf a numpy array) -> the port's
    checkpoint payload (module docstring). The optimizer state is read
    from optax's structure by its field names: apply_if_finite's counters
    and each parameter group's scale_by_adam count and second moments."""
    st = jck["state"]
    opt = st.opt_state
    groups = opt.inner_state.inner_states
    nu: Dict[str, Any] = {}
    count = None
    for g in groups.values():
        adam = g.inner_state[0]
        _merge_leaves(nu, adam.nu)
        count = int(adam.count)
    params = st.params
    return {
        "state": {
            "params": {"params": _np_tree(params["params"])},
            "ema_params": _np_tree(st.ema_params),
            "step": np.int32(st.step),
            "opt_state": {"count": np.int32(count or 0),
                          "notfinite_count": np.int32(opt.notfinite_count),
                          "total_notfinite": np.int32(opt.total_notfinite),
                          "nu": nu}},
        "occ": {k: np.asarray(v) for k, v in dict(jck["occ"]).items()},
        "generator": None}


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _fill_masked(template, values: Dict[str, Any]):
    """The masked optax tree `template` with each array leaf replaced by
    the same path's leaf of `values` (MaskedNode leaves stay)."""
    if isinstance(template, dict):
        return {k: _fill_masked(v, values.get(k, {}) if isinstance(
            values, dict) else {}) for k, v in template.items()}
    if _is_leaf_array(template) or hasattr(template, "shape"):
        return np.asarray(values, dtype=np.asarray(template).dtype)
    return template


def checkpoint_to_jax(ck: Dict[str, Any], template) -> Dict[str, Any]:
    """The port's checkpoint payload -> the JAX CLI's {"state": TrainState,
    "occ": dict}, written into `template` (that payload as the JAX
    package's TrainState.create and its occupancy build it, any leaves):
    the parameters, EMA and step, apply_if_finite's counters, and in each
    parameter group the schedule counts and second moments; the first
    moments are zeros (they are not kept; with b1 = 0 no step reads
    them). Imports no JAX: the optax states are filled through their
    namedtuple _replace."""
    st = ck["state"]
    opt = st["opt_state"]
    count = np.int32(opt["count"])
    t_state = template["state"]
    t_opt = t_state.opt_state
    groups = {}
    for label, g in t_opt.inner_state.inner_states.items():
        inner = []
        for part in g.inner_state:
            fields = getattr(part, "_fields", ())
            if "nu" in fields:
                part = part._replace(
                    count=count,
                    mu=_fill_masked(part.mu, _zeros_like_tree(opt["nu"])),
                    nu=_fill_masked(part.nu, opt["nu"]))
            elif "count" in fields:
                part = part._replace(count=count)
            inner.append(part)
        groups[label] = g._replace(inner_state=tuple(inner))
    new_opt = t_opt._replace(
        notfinite_count=np.int32(opt["notfinite_count"]),
        total_notfinite=np.int32(opt["total_notfinite"]),
        last_finite=np.asarray(True),
        inner_state=t_opt.inner_state._replace(inner_states=groups))
    params = dict(t_state.params)
    params["params"] = _np_tree(st["params"]["params"])
    state = t_state.replace(params=params,
                            ema_params=_np_tree(st["ema_params"]),
                            step=np.int32(st["step"]), opt_state=new_opt)
    return {"state": state,
            "occ": {k: np.asarray(v) for k, v in ck["occ"].items()}}


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return np.zeros_like(np.asarray(tree))
