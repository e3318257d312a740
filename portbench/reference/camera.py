"""FoV perspective cameras on a random look-at rig (PyTorch3D conventions).

Row vectors, ``X_view = X_world @ R + T``, the camera looking down +Z;
NDC with +X left and +Y up, ``x_ndc = x_view / (tan(fov / 2) z_view)``
(aspect 1); pixel (row i, column j) has its center at screen (x = j, y = i).
Every operation runs in float32 in the order PyTorch3D (and the port, which
follows it) takes, so that both place a vertex on the same float32 screen
position: visibility is discrete, and a pixel center on an edge must fall
on the same side in both.

The rig is the reference repository's second approach: ``n`` views with
cos(elevation) ~ U(-1, 1) and azimuth ~ U(-180, 180) degrees, drawn in that
order by ``numpy.random.RandomState(seed)``, at distance 2.10 from the
look-at point (0, 0.10, 0.25), up +Y, fov 60 degrees.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

FOV_DEG = 60.0
DIST = 2.10
AT = (0.0, 0.10, 0.25)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)


def random_rig(n: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R (n, 3, 3), T (n, 3)) float32 on the CPU, each operation in
    float32 in PyTorch3D's order (``look_at_view_transform``)."""
    rng = np.random.RandomState(seed)
    cos_e = rng.rand(n) * 2.0 - 1.0
    elev = np.arccos(cos_e) * 180.0 / math.pi - 90.0
    azim = rng.rand(n) * 360.0 - 180.0
    dist = torch.full((n,), DIST, dtype=torch.float32)
    e = torch.deg2rad(torch.as_tensor(elev, dtype=torch.float32))
    a = torch.deg2rad(torch.as_tensor(azim, dtype=torch.float32))
    at = torch.tensor(AT, dtype=torch.float32).expand(n, 3)
    pos = torch.stack([dist * torch.cos(e) * torch.sin(a),
                       dist * torch.sin(e),
                       dist * torch.cos(e) * torch.cos(a)], dim=-1) + at
    up = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)
    z = _unit(at - pos)
    x = torch.linalg.cross(up, z)
    # Looking straight up or down: a horizontal x axis instead.
    flat = torch.linalg.norm(x, dim=-1, keepdim=True) < 1e-6
    alt = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0]).expand(n, 3), z)
    x = _unit(torch.where(flat, alt, x))
    y = _unit(torch.linalg.cross(z, x))
    R = torch.stack([x, y, z], dim=-1)
    T = -torch.bmm(pos[:, None, :], R)[:, 0]
    return R, T


def to_screen(verts: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
              size: int) -> torch.Tensor:
    """(n, V, 3) screen (x_pix, y_pix, z_view) of world verts (V, 3)."""
    n = R.shape[0]
    view = torch.bmm(verts.float()[None].expand(n, -1, -1), R) + T[:, None]
    fov = torch.full((n,), FOV_DEG, dtype=torch.float32, device=R.device)
    tan_half = torch.tan(torch.deg2rad(fov) * 0.5)
    sx = 1.0 / tan_half
    z = view[..., 2]
    tiny = torch.where(z < 0, torch.full_like(z, -1e-8),
                       torch.full_like(z, 1e-8))
    z = torch.where(torch.abs(z) < 1e-8, tiny, z)
    x_ndc = view[..., 0] * sx[:, None] / z
    y_ndc = view[..., 1] * sx[:, None] / z
    half = size * 0.5
    return torch.stack([(1.0 - x_ndc) * half - 0.5,
                        (1.0 - y_ndc) * half - 0.5, view[..., 2]], dim=-1)
