"""Load a trained state without JAX: the one the JAX package writes
(scripts/train_production.py: trained/production_state.pkl) or the port's
(lzzx_nerf_tpu_torch/tools/train_production.py).

The JAX pickle stores the trees' structure as pickled JAX PyTreeDef
objects; unpickling them would import jax. _StateUnpickler hands back an
inert stub for every jax/jaxlib class instead; the port's file has no
treedef. Either way the torso tree is rebuilt from its leaves, which are
stored in the sorted key-path order of the flax params tree
(TORSO_LEAF_PATHS; flatten_paths gives the writer that order).
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

# the torso params tree's leaves in sorted key-path order
TORSO_LEAF_PATHS = (
    "anchor_points",
    "individual_codes_torso",
    "torso_deform_net/net_0/kernel",
    "torso_deform_net/net_1/kernel",
    "torso_deform_net/net_2/kernel",
    "torso_encoder_l0",
    "torso_encoder_l1",
    "torso_encoder_l2",
    "torso_encoder_l3",
    "torso_net/net_0/kernel",
    "torso_net/net_1/kernel",
    "torso_net/net_2/kernel",
)


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
    if leaves is not None and len(leaves) != len(TORSO_LEAF_PATHS):
        raise ValueError(f"{path}: {len(leaves)} torso leaves, expected "
                         f"{len(TORSO_LEAF_PATHS)}")
    return {"head": st["head_ema"],
            "torso": (None if leaves is None
                      else _nest(TORSO_LEAF_PATHS, leaves)),
            "occ": {k: np.asarray(v) for k, v in st["occ"].items()},
            "meta": st["meta"]}


def params_from_jax(tree: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays) -> state_dict of the
    port's modules. Dense kernels [in, out] become Linear weights
    [out, in]; Conv kernels [k, in, out] become Conv1d weights
    [out, in, k]; biases and raw parameters keep their layout. A top-level
    "params" collection is unwrapped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(params_from_jax(val, f"{prefix}{key}."))
            continue
        a = np.asarray(val, dtype=np.float32)
        if key == "kernel":
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
        if key == "weight":
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
