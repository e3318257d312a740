"""Checkpoint / resume (counterpart of ``st3d/utils/checkpoint.py``).

A checkpoint is one flat ``.npz`` in the JAX package's key layout:
``__step__`` (the progress counter), the trainable leaves as ``p{i}`` in
sorted-key order, the Adam state as ``o{i}`` in optax's leaf order of
``ScaleByAdamState`` (``count``, then every ``mu`` leaf, then every ``nu``
leaf, each in sorted-key order) and ``extras`` as ``x_{name}``. The random
state is the port's own: the ``torch.Generator`` state under ``g_state``
(``jax.random`` and torch draw different bits from one seed).

``torch.optim.Adam`` keeps a ``step`` per parameter where optax keeps one
shared ``count``; every leaf of one optimizer takes the same steps, so one
``count`` leaf is written and restored into each.

In a world of several ranks only rank 0 writes, and every rank reads. The
data-parallel leaves are the same on every rank; the multi-style and fleet
engines, whose ranks each own a block of the cell grid, pass ``leaf_out``
(every rank's block gathered into the whole, unpadded grid: the file is
the JAX package's unsharded layout, whatever the world that wrote it) and
``leaf_in`` (this rank's block of a whole grid).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

GENERATOR_KEY = "g_state"


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def adam_leaves(optimizer: torch.optim.Optimizer,
                params: Dict[str, torch.Tensor],
                leaf: Optional[Callable] = None) -> List[np.ndarray]:
    """optax's ``ScaleByAdamState`` leaves of ``optimizer`` over ``params``:
    [count (int32 scalar), mu per leaf..., nu per leaf...], the leaves in
    sorted-key order; zeros before the first step. ``leaf`` maps each
    moment (a tensor) first."""
    leaf = leaf or (lambda t: t)
    names = sorted(params)
    states = [optimizer.state.get(params[k], {}) for k in names]
    steps = {int(s["step"]) for s in states if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"Adam leaves took different step counts: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moment(key):
        return [_np(leaf(s[key] if key in s
                         else torch.zeros_like(params[k].detach())))
                for k, s in zip(names, states)]

    return [count] + moment("exp_avg") + moment("exp_avg_sq")


def save_checkpoint(path: str, step: int, params: Dict[str, torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator,
                    extras: Dict[str, Any] = None, write: bool = True,
                    leaf_out: Optional[Callable] = None) -> None:
    """Write ``path`` atomically (to ``path + ".tmp.npz"``, then
    ``os.replace``): a crash mid-write never leaves a torn checkpoint.
    ``extras`` are named arrays restored verbatim (e.g. the first
    approach's mid-batch step and 2D-stylised targets). ``leaf_out`` maps
    each trainable leaf and Adam moment before it is written; a collective
    one is called on every rank, and only the rank with ``write`` writes."""
    leaf = leaf_out or (lambda t: t)
    arrays: Dict[str, np.ndarray] = {"__step__": np.asarray(step)}
    for i, k in enumerate(sorted(params)):
        arrays[f"p{i}"] = _np(leaf(params[k].detach()))
    for i, v in enumerate(adam_leaves(optimizer, params, leaf)):
        arrays[f"o{i}"] = v
    if not write:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays[GENERATOR_KEY] = _np(generator.get_state())
    for k, v in (extras or {}).items():
        arrays[f"x_{k}"] = _np(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _leaf(data, path: str, key: str, like: np.ndarray,
          mapped: Optional[Callable] = None) -> np.ndarray:
    """``data[key]`` (through ``mapped``), raising ValueError unless it has
    ``like``'s shape and dtype."""
    if key not in data:
        raise ValueError(f"checkpoint {path} is missing {key}; was it "
                         "written with a different configuration?")
    arr = mapped(data[key]) if mapped else data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {key} has shape {arr.shape}, expected "
            f"{like.shape} (different optimization_target, size, or mesh?)")
    if arr.dtype != like.dtype:
        raise ValueError(
            f"checkpoint leaf {key} has dtype {arr.dtype}, expected "
            f"{like.dtype} (different compute_dtype?): a silent cast would "
            "resume with different numerics")
    return arr


def load_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator,
                    leaf_in: Optional[Callable] = None
                    ) -> Tuple[int, Dict[str, np.ndarray]]:
    """Restore a checkpoint in place into ``params`` (leaf tensors),
    ``optimizer`` and ``generator``; returns the step and the extras (name
    -> array). ``leaf_in`` maps each stored trainable leaf and Adam moment
    (an array) to this rank's. Raises ValueError naming the leaf on a
    missing leaf or a shape or dtype mismatch (e.g. resuming with a
    different optimization_target or texture size), before anything is
    restored."""
    from st3d_torch.convert import adam_state_from_numpy

    like = adam_leaves(optimizer, params)
    n = len(params)
    with np.load(path) as data:
        step = int(data["__step__"])
        values = [_leaf(data, path, f"p{i}", _np(params[k]), leaf_in)
                  for i, k in enumerate(sorted(params))]
        opt = [_leaf(data, path, f"o{i}", ref, leaf_in if i else None)
               for i, ref in enumerate(like)]
        state = _leaf(data, path, GENERATOR_KEY, _np(generator.get_state()))
        extras = {k[2:]: data[k] for k in data.files if k.startswith("x_")}
    with torch.no_grad():
        for k, v in zip(sorted(params), values):
            params[k].copy_(torch.from_numpy(v))
    adam_state_from_numpy(optimizer, params, opt[0], opt[1:1 + n],
                          opt[1 + n:])
    generator.set_state(torch.from_numpy(state.copy()))
    return step, extras


def restore(resume: bool, path: str, params, optimizer, generator,
            leaf_in: Optional[Callable] = None
            ) -> Tuple[int, Dict[str, np.ndarray]]:
    """(step, extras) of the checkpoint at ``path``, restored into the
    state, when ``resume`` is set and the file exists; else (0, {})."""
    if not (resume and os.path.isfile(path)):
        return 0, {}
    step, extras = load_checkpoint(path, params, optimizer, generator,
                                   leaf_in)
    print(f"Resumed from {path} at step {step}"
          + (f", within it {int(extras['mse_done'])}" if "mse_done" in extras
             else ""))
    return step, extras
