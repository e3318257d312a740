"""The cell grid of the multi-style and fleet engines over the ranks
(counterpart of the device grids of ``st3d/engine/multistyle.py:176-205``
and ``st3d/engine/fleetbatch.py:250-330``).

The M x S (mesh, style) cells are independent: each owns its texture and
its Adam moments, so sharding them needs no gradient collective. The ranks
form a ``dm x ds`` grid, rank r being cell ``(r // ds, r % ds)`` of it, the
row-major order of ``np.asarray(jax.devices()).reshape(dm, ds)``; the cell
grid is padded to ``m_pad x s_pad`` (multiples of dm and ds) by repeating
row or column 0, and the padded cells are masked to zero loss, so they
never move and never touch a real cell. Checkpoints hold the real M x S
grid whatever the world that wrote them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from st3d_torch.parallel.sharding import World, gather_cat


def _pick_grid(n_dev: int, n_meshes: int, n_styles: int):
    """Factor ``n_dev`` into (mesh_devices, style_devices) and pick padded
    grid sizes: returns ``(dm, ds, m_pad, s_pad)`` with ``m_pad`` / ``s_pad``
    the smallest multiples of ``dm`` / ``ds`` covering the real grid. The
    factorisation with the fewest padded cells wins; ties shard the style
    axis harder (st3d/engine/fleetbatch.py:70-91)."""
    best = None
    for ds in range(n_dev, 0, -1):
        if n_dev % ds:
            continue
        dm = n_dev // ds
        m_pad = -(-n_meshes // dm) * dm
        s_pad = -(-n_styles // ds) * ds
        key = (m_pad * s_pad, -ds)
        if best is None or key < best[0]:
            best = (key, (dm, ds, m_pad, s_pad))
    return best[1]


def _pad_axis(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Grow ``axis`` to ``size`` by repeating its first slice (padded cells
    must shade to finite values: they are masked, not skipped)."""
    n = a.shape[axis]
    if n == size:
        return a
    first = a.narrow(axis, 0, 1)
    rep = first.expand(a.shape[:axis] + (size - n,) + a.shape[axis + 1:])
    return torch.cat([a, rep], dim=axis)


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """The M x S cells (``n_meshes`` x ``n_styles``) over a ``dm x ds``
    grid of the ranks of ``world``, padded to ``m_pad x s_pad``; a world
    of 1 holds them all."""

    world: World
    n_meshes: int
    n_styles: int
    dm: int = 1
    ds: int = 1
    m_pad: int = 0
    s_pad: int = 0

    @classmethod
    def whole(cls, n_meshes: int, n_styles: int) -> "CellGrid":
        """Every cell on this rank."""
        return cls(World(), n_meshes, n_styles, 1, 1, n_meshes, n_styles)

    @classmethod
    def fleet(cls, world: World, n_meshes: int, n_styles: int) -> "CellGrid":
        """The fleet's grid: ``_pick_grid``'s factorisation and padding."""
        dm, ds, m_pad, s_pad = _pick_grid(world.size, n_meshes, n_styles)
        return cls(world, n_meshes, n_styles, dm, ds, m_pad, s_pad)

    @classmethod
    def styles(cls, world: World, n_styles: int) -> "CellGrid":
        """Multi-style: each rank a contiguous block of the styles, which
        the ranks must divide."""
        if n_styles % world.size:
            raise ValueError(
                f"data_parallel multistyle needs the style count "
                f"({n_styles}) to divide the {world.size} devices")
        return cls(world, 1, n_styles, 1, world.size, 1, n_styles)

    @property
    def mb(self) -> int:
        return self.m_pad // self.dm

    @property
    def sb(self) -> int:
        return self.s_pad // self.ds

    def mesh_ids(self) -> List[int]:
        """The meshes of this rank's rows of cells (a padded row repeats
        mesh 0)."""
        i0 = self.world.rank // self.ds * self.mb
        return [i if i < self.n_meshes else 0 for i in range(i0, i0 + self.mb)]

    def style_ids(self) -> List[int]:
        """The styles of this rank's columns of cells."""
        j0 = self.world.rank % self.ds * self.sb
        return [j if j < self.n_styles else 0
                for j in range(j0, j0 + self.sb)]

    def mask(self, device) -> torch.Tensor:
        """(mb, sb) float32: 1 on this rank's real cells, 0 on padded
        ones."""
        i0 = self.world.rank // self.ds * self.mb
        j0 = self.world.rank % self.ds * self.sb
        rows = torch.arange(i0, i0 + self.mb, device=device) < self.n_meshes
        cols = torch.arange(j0, j0 + self.sb, device=device) < self.n_styles
        return (rows[:, None] & cols[None, :]).to(torch.float32)

    @property
    def padded(self) -> bool:
        return (self.m_pad, self.s_pad) != (self.n_meshes, self.n_styles)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The real (M, S, ...) grid from every rank's (mb, sb, ...) block
        (``all_gather``)."""
        blocks = gather_cat(block[None], self.world)
        rows = [torch.cat(list(blocks[r * self.ds:(r + 1) * self.ds]), dim=1)
                for r in range(self.dm)]
        return torch.cat(rows, dim=0)[:self.n_meshes, :self.n_styles]

    def block(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's (mb, sb, ...) block of the real (M, S, ...) grid,
        padded first."""
        if tuple(whole.shape[:2]) != (self.n_meshes, self.n_styles):
            raise ValueError(
                f"a grid of {tuple(whole.shape[:2])} cells is not this "
                f"run's {self.n_meshes} x {self.n_styles}")
        full = _pad_axis(_pad_axis(whole, 0, self.m_pad), 1, self.s_pad)
        i0 = self.world.rank // self.ds * self.mb
        j0 = self.world.rank % self.ds * self.sb
        return full[i0:i0 + self.mb, j0:j0 + self.sb]

    def block_of_array(self, whole: np.ndarray) -> np.ndarray:
        """``block`` of a checkpoint's array (``load_checkpoint``'s
        ``leaf_in``)."""
        return np.ascontiguousarray(self.block(torch.from_numpy(whole)).numpy())
