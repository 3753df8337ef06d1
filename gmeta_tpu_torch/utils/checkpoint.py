"""Checkpoint / resume.

Counterpart of gmeta_tpu/utils/checkpoint.py, with its file names
(`ckpt_{step:08d}.pkl`, the `latest` symlink, tmp + rename) and its dict
keys (`params`, `opt_state`, `best_params`, `max_acc`, `epoch`,
`batch_in_epoch`, `step`). The full training state is serialized so resume
restores the exact protocol state; data order needs no RNG blob, because
the epoch's task order is a pure function of (config seed, epoch) and the
saved in-epoch position pins the remaining stream.

Format: a pickle of numpy leaves (tensors as `.detach().cpu().numpy()`),
the JAX package's format: `opt_state` is written as optax.adam's pickled
state, `(ScaleByAdamState(count, mu, nu), EmptyState())`, under optax's
module and class names, so that the JAX package resumes a checkpoint the
port wrote. Neither optax nor jax is imported for it: local stand-ins
(`_ScaleByAdamState`, `_EmptyState`) are pickled under optax's names by a
pure-Python pickler. `restore` reads that layout, through a restricted
unpickler that maps optax's two classes back to the stand-ins, and also
the dict of `AdamState`'s fields {"count", "mu", "nu"} that the port
wrote before; it returns `opt_state` in the port's layout either way.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # AdamState
        adam = _ScaleByAdamState(*(_to_numpy(getattr(tree, k))
                                   for k in ("count", "mu", "nu")))
        return (adam, _EmptyState())                 # optax.adam's state
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(x) for x in tree)
    return np.asarray(tree)


def save(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(_to_numpy(state))
    os.replace(tmp, path)
    latest = os.path.join(ckpt_dir, "latest")
    tmp_link = latest + ".tmp"
    if os.path.islink(tmp_link) or os.path.exists(tmp_link):
        os.remove(tmp_link)
    os.symlink(os.path.basename(path), tmp_link)
    os.replace(tmp_link, latest)
    return path


def latest_path(ckpt_dir: str) -> Optional[str]:
    p = os.path.join(ckpt_dir, "latest")
    if os.path.exists(p):
        return os.path.join(ckpt_dir, os.readlink(p)) if os.path.islink(p) else p
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_")) if os.path.isdir(ckpt_dir) else []
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


class _ScaleByAdamState(NamedTuple):
    """Stands in for optax._src.transform.ScaleByAdamState when unpickling."""
    count: Any
    mu: Any
    nu: Any


class _EmptyState(NamedTuple):
    """Stands in for optax._src.base.EmptyState when unpickling."""


_OPTAX = {("optax._src.transform", "ScaleByAdamState"): _ScaleByAdamState,
          ("optax._src.base", "EmptyState"): _EmptyState}
_OPTAX_NAMES = {cls: key for key, cls in _OPTAX.items()}


class _Pickler(pickle._Pickler):
    """Writes the stand-ins under optax's module and class names, as
    optax's own classes pickle; everything else as pickle does. The
    pure-Python pickler, because the C one resolves every class it writes
    by importing its module."""

    def save_global(self, obj, name=None):
        if obj not in _OPTAX_NAMES:
            return super().save_global(obj, name)
        module, qualname = _OPTAX_NAMES[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


# what numpy arrays, dtypes and scalars pickle through (numpy 1.x and 2.x)
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_frombuffer", "_reconstruct", "dtype", "ndarray", "scalar")


class _Unpickler(pickle.Unpickler):
    """Resolves only the classes a checkpoint of either package holds:
    numpy arrays and the optax Adam state, mapped to local classes."""

    def find_class(self, module, name):
        if (module, name) in _OPTAX:
            return _OPTAX[(module, name)]
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a checkpoint does not hold {module}.{name}")


def _adam_fields(opt_state) -> Dict[str, Any]:
    """{"count", "mu", "nu"} from optax's layout or the port's former
    dict."""
    if isinstance(opt_state, dict):
        return opt_state
    adam = opt_state[0] if isinstance(opt_state, tuple) and opt_state else None
    if not isinstance(adam, _ScaleByAdamState):
        raise ValueError(f"unknown opt_state layout: {type(opt_state)}")
    return {"count": adam.count, "mu": tuple(adam.mu), "nu": tuple(adam.nu)}


def _writable(tree):
    """Arrays unpickled from protocol-5 buffers are read-only; copy them,
    so tensors made from them may be written."""
    if isinstance(tree, np.ndarray):
        return tree if tree.flags.writeable else tree.copy()
    if isinstance(tree, dict):
        return {k: _writable(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_writable(x) for x in tree)
    return tree


def restore(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        state = _Unpickler(f).load()
    state["opt_state"] = _adam_fields(state["opt_state"])
    return _writable(state)
