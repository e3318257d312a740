"""NaN/Inf guard for ``--debug_nan`` (counterpart of ``st3d/utils/debug.py``,
whose ``checkify`` guard raises on the host after a jitted step).

``check_finite`` tests every floating leaf of a step's loss, gradients or
updated parameters with ``torch.isfinite`` and raises FloatingPointError
naming where (the epoch or step, the leaf) and what ("nan" or "inf"). It
costs one host synchronisation per call, so the pipelines call it only
when the flag is set; with the flag off the step is unchanged. In a world
of several ranks the count of non-finite leaves is summed over the ranks
first, so every rank raises together and none waits in a collective for a
rank that stopped.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from st3d_torch.parallel.sharding import World, all_sum

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def check_finite(tree: Tree, label: str,
                 world: Optional[World] = None) -> None:
    """Raise FloatingPointError unless every floating leaf of ``tree`` (a
    tensor, or a dict of name -> tensor or None) is finite on every rank of
    ``world``; the message names ``label``, the leaf and whether it holds a
    nan or an inf (on a rank whose own leaves are finite, only that
    another rank's are not)."""
    leaves = ({"": tree} if isinstance(tree, torch.Tensor) else
              {f"[{k!r}]": t for k, t in sorted(tree.items())
               if t is not None})
    leaves = {k: t.detach() for k, t in leaves.items()
              if t.is_floating_point()}
    if not leaves:
        return
    bad = torch.stack([~torch.isfinite(t).all()
                       for t in leaves.values()]).sum().to(torch.float32)
    if world is not None and world.sharded:
        total = all_sum(bad.reshape(1).to(world.device), world)
        if float(total) and not float(bad):
            raise FloatingPointError(
                f"non-finite values in {label} on another rank")
    if not float(bad):
        return
    for name, t in leaves.items():
        if not bool(torch.isfinite(t).all()):
            kind = "nan" if bool(torch.isnan(t).any()) else "inf"
            raise FloatingPointError(
                f"non-finite values ({kind}) in {label}{name}")
