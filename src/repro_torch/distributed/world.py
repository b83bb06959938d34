"""Process groups for the port's meshes: one process per rank, the
rendezvous through a file (no network).

``spawn(fn, world, store_path)`` starts ``world`` processes (the ``spawn``
start method), each of which joins the default group (gloo unless told
otherwise) and calls ``fn(rank, world, *args)``; it returns when all have
ended and raises if one failed. ``fn`` must be importable (module level).
NCCL takes one card per rank; ranks that share a card use gloo and keep
their tensors on it (``collectives`` moves them through the host).
"""
from __future__ import annotations

import torch.distributed as dist
import torch.multiprocessing as mp


def init(rank: int, world: int, store_path: str,
         backend: str = "gloo") -> None:
    """Join the default process group of ``world`` ranks through the file
    ``store_path`` (absent or empty before the first rank joins)."""
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)


def _entry(rank, fn, world, store_path, backend, args):
    init(rank, world, store_path, backend)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, store_path: str, backend: str = "gloo",
          args: tuple = ()) -> None:
    mp.spawn(_entry, args=(fn, world, store_path, backend, args),
             nprocs=world, join=True)
