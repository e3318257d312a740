"""NaN/Inf guard for ``--debug_nan`` (counterpart of ``st3d/utils/debug.py``,
whose ``checkify`` guard raises on the host after a jitted step).

``check_finite`` tests every floating leaf of a step's loss, gradients or
updated parameters with ``torch.isfinite`` and raises FloatingPointError
naming where (the epoch or step, the leaf) and what ("nan" or "inf"). It
costs one host synchronisation per call, so the pipelines call it only
when the flag is set; with the flag off the step is unchanged.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def check_finite(tree: Tree, label: str) -> None:
    """Raise FloatingPointError unless every floating leaf of ``tree`` (a
    tensor, or a dict of name -> tensor or None) is finite; the message
    names ``label``, the leaf and whether it holds a nan or an inf."""
    leaves = ({"": tree} if isinstance(tree, torch.Tensor) else
              {f"[{k!r}]": t for k, t in sorted(tree.items())
               if t is not None})
    leaves = {k: t.detach() for k, t in leaves.items()
              if t.is_floating_point()}
    if not leaves:
        return
    if bool(torch.stack([torch.isfinite(t).all()
                         for t in leaves.values()]).all()):
        return
    for name, t in leaves.items():
        if not bool(torch.isfinite(t).all()):
            kind = "nan" if bool(torch.isnan(t).any()) else "inf"
            raise FloatingPointError(
                f"non-finite values ({kind}) in {label}{name}")
