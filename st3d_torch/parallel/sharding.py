"""The world of ranks, view shards and the data-parallel step (counterpart
of ``st3d/parallel/sharding.py``).

The JAX package runs one process over N devices and shards the view batch
on a 1-D mesh with ``shard_map``. Here the devices are the ranks of a
``torch.distributed`` world, one process each, as ``torchrun`` starts
them (``python -m torch.distributed.run --standalone --nproc_per_node N
-m st3d_torch.<cli> ...``). A process started without ``WORLD_SIZE`` is a
world of 1 and runs the unsharded path, as the JAX package does on one
device.

Rank r takes the contiguous block ``[r·B/W, (r+1)·B/W)`` of a batch of B
views, as ``NamedSharding(P('views'))`` places it. The parameters are
replicated: every rank applies the same averaged gradient to the same
leaves, so they stay bit-identical. Only three collectives are used:
``all_reduce`` with SUM (gloo has no AVG: the mean divides by W),
``broadcast`` and ``all_gather``, each called by every rank in the same
order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from st3d_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world: its ``rank`` of ``size``, its
    ``device`` and the process group's ``backend`` (None in a world of
    1, where no group exists)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def sharded(self) -> bool:
        return self.size > 1

    @property
    def main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; asking for CUDA without a GPU raises (there
    is no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA GPU is available; pass "
            "--device cpu to run the kernels' plain versions")
    return dev


def pick_backend(device_type: str, n_cards: int, local_size: int) -> str:
    """``nccl`` when every rank of the host has a card of its own, ``gloo``
    when ranks share a card (NCCL refuses two ranks on one device) and on
    the CPU."""
    if device_type == "cuda" and n_cards >= local_size:
        return "nccl"
    return "gloo"


def rank_device(name: str, local_rank: int) -> torch.device:
    """The device of the rank with ``local_rank`` on its host: the CPU, or
    card ``local_rank % torch.cuda.device_count()``."""
    dev = resolve_device(name)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def current_world(device: str) -> World:
    """The world this process belongs to: the initialised process group's,
    or a world of 1 on ``device``."""
    if not (dist.is_available() and dist.is_initialized()):
        return World(device=resolve_device(device))
    return World(dist.get_rank(), dist.get_world_size(),
                 rank_device(device, _local_rank()), dist.get_backend())


def init_world(device: str, init_method: Optional[str] = None) -> World:
    """Join the world that ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    describe (as ``torchrun`` sets them; ``init_method`` defaults to
    ``env://``, its rendezvous) and return it; a world of 1 without
    ``WORLD_SIZE``. The backend follows ``pick_backend`` and is printed
    once, by rank 0. A process group that exists already is kept."""
    if dist.is_available() and dist.is_initialized():
        return current_world(device)
    size = int(os.environ.get("WORLD_SIZE", "1"))
    if size == 1:
        return World(device=resolve_device(device))
    rank, local = int(os.environ["RANK"]), _local_rank()
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
    dev = rank_device(device, local)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = pick_backend(dev.type, cards, local_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=size)
    if rank == 0:
        shared = dev.type == "cuda" and cards < local_size
        print(f"torch.distributed: world {size}, backend {backend}, "
              f"{local_size} ranks on {cards or 'no'} card(s) of this host"
              + (" (ranks share a card: gloo)" if shared else ""),
              flush=True)
    return World(rank, size, dev, backend)


@contextlib.contextmanager
def distributed(device: str, init_method: Optional[str] = None):
    """``init_world`` for the span of a ``with`` block; the process group
    is destroyed on leaving it, unless it existed before."""
    created = not (dist.is_available() and dist.is_initialized())
    world = init_world(device, init_method)
    try:
        yield world
    finally:
        if created and world.sharded:
            dist.destroy_process_group()


def make_device_mesh(world: World,
                     n_devices: Optional[int] = None) -> Tuple[int, ...]:
    """The ranks of a 1-D mesh over the first ``n_devices`` ranks (all of
    them by default)."""
    n = n_devices or world.size
    if n > world.size:
        raise ValueError(
            f"requested {n} devices but only {world.size} present (start "
            "more ranks: torchrun --nproc_per_node N)")
    return tuple(range(n))


def view_block(n_views: int, world: World) -> slice:
    """This rank's contiguous block of ``n_views`` views; raises unless the
    ranks divide the views."""
    if n_views % world.size:
        raise ValueError(
            f"data_parallel requires every view batch to divide the "
            f"{world.size} devices; got batch of {n_views} views "
            "(adjust --n_views/--batch_size)")
    per = n_views // world.size
    return slice(world.rank * per, (world.rank + 1) * per)


def shard_views(tree, world: World):
    """Every tensor leaf of ``tree`` (a tensor, or a dict, list or tuple of
    them) cut to this rank's block of its leading (view) axis."""
    if isinstance(tree, dict):
        return {k: shard_views(v, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_views(v, world) for v in tree)
    return tree[view_block(tree.shape[0], world)]


def replicate(tensors: Iterable[torch.Tensor], world: World) -> None:
    """Overwrite every tensor in place with rank 0's (``broadcast``)."""
    if world.sharded:
        for t in tensors:
            dist.broadcast(t, 0)


def all_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of ``t`` over the ranks (``all_reduce`` SUM), a new tensor;
    ``t`` itself in a world of 1."""
    if not world.sharded:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_mean(t: torch.Tensor, world: World) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``pmean``): the sum divided by the
    world, gloo having no AVG."""
    return all_sum(t, world) / world.size if world.sharded else t


def gather_cat(t: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's ``t`` (of one shape) concatenated along its first axis
    in rank order (``all_gather``)."""
    if not world.sharded:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def average_gradients(params: Iterable[torch.Tensor], world: World) -> None:
    """Replace each gradient by its mean over the ranks, in place."""
    if not world.sharded:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM)
            p.grad.div_(world.size)


def make_view_parallel_step(loss_fn: Callable,
                            optimizer: torch.optim.Optimizer,
                            params: Dict[str, torch.Tensor],
                            world: Optional[World], has_aux: bool = False,
                            check: Optional[Callable] = None) -> Callable:
    """The data-parallel optimisation step over the leaves ``params``
    (name -> tensor) that ``optimizer`` updates.

    ``loss_fn(*args)`` returns this rank's scalar loss, a mean over its
    block of views (or ``(loss, aux)`` with ``has_aux``). ``step(*args,
    label='')`` zeroes the gradients, runs ``loss_fn`` and its backward,
    averages every gradient and the loss over ``world`` (the ``pmean``s of
    the JAX step; every per-view term is a batch mean, so the mean over
    equal shards is the whole batch's) and takes one optimizer step on
    every rank. It returns the averaged loss, detached (and ``aux``).
    ``world=None`` keeps the gradients and the loss local, for leaves that
    each rank owns alone. ``check(tree, what)``, where given, runs on the
    loss, the gradients and the updated leaves, ``what`` naming ``label``
    and the stage (``--debug_nan``). The step runs in the span ``st3d.step``
    with its ``forward``, ``backward``, ``optim`` and ``check`` phases
    (``utils/trace.py``)."""
    world = world or World()

    @trace.spanned("step")
    def step(*args, label: str = ""):
        trace.count("steps")
        with trace.span("optim"):
            optimizer.zero_grad(set_to_none=True)
        with trace.span("forward"):
            out = loss_fn(*args)
            loss, aux = out if has_aux else (out, None)
            mean = all_mean(loss.detach(), world)
        if check:
            with trace.span("check"):
                check(mean, f"{label} loss")
        with trace.span("backward"):
            loss.backward()
            average_gradients(params.values(), world)
        if check:
            with trace.span("check"):
                check({k: p.grad for k, p in params.items()},
                      f"{label} gradient")
        with trace.span("optim"):
            optimizer.step()
        if check:
            with trace.span("check"):
                check(params, f"{label} parameter")
        return (mean, aux) if has_aux else mean

    return step
