"""Atomic, async-capable checkpointing of trees of tensors.

Port of ``repro/checkpoint/checkpointer.py``, with its layout:
``<dir>/step_<N>/shard_<host>.npz`` + ``manifest.json``. Writes go to
``<dir>/.tmp_step_<N>`` then ``os.rename`` (atomic on POSIX), so a crash
mid-save never corrupts the latest checkpoint. The npz keys are the
reference's leaf paths (``tree.flatten_with_path``), so a checkpoint
written by either package restores into the other's tree.

Over a mesh a checkpoint still holds full arrays: a DTensor leaf is
gathered (``full_tensor``, a collective every rank joins) and rank 0
writes. ``restore`` lays each leaf out on the current mesh (a target
DTensor's layout, or the ``placements`` given), so loading into a mesh of
another shape (elastic restart) is the same code path.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_lib
from repro_torch.distributed import sharding as shlib

PyTree = Any


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (never a view of a tensor
    that training goes on updating); bfloat16 is stored as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in tree_lib.flatten_with_path(tree)}


def _writer() -> bool:
    """Whether this process writes (rank 0 of a process group, or alone)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str | Path, step: int, tree: PyTree,
         host_id: int = 0, extra: Optional[Dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    final = ckpt_dir / f"step_{step:08d}"
    flat = _flatten(tree)
    if not _writer():
        return final
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"shard_{host_id}.npz", **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    return final


def save_async(ckpt_dir: str | Path, step: int, tree: PyTree,
               host_id: int = 0, extra: Optional[Dict] = None
               ) -> threading.Thread:
    """Snapshot to host memory synchronously, write to disk off-thread."""
    host_tree = tree_lib.tree_map(_host, tree)
    t = threading.Thread(target=save,
                         args=(ckpt_dir, step, host_tree, host_id, extra))
    t.start()
    return t


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, target: PyTree,
            device=None, host_id: int = 0, placements: PyTree = None,
            mesh=None) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``target`` (a tree of tensors).

    Each leaf takes the target leaf's dtype and goes to ``device``, or to
    the target leaf's device when ``device`` is None. It is then laid out
    on ``mesh`` by ``placements`` (a matching placements tree), or like the
    target leaf where that is a DTensor: the elastic-restart path when the
    mesh changed since the save. Raises on a shape mismatch.
    """
    final = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    with np.load(final / f"shard_{host_id}.npz") as z:
        flat = {k: z[k] for k in z.files}
    out = []
    for key, leaf in tree_lib.flatten_with_path(target):
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"ckpt {arr.shape} vs target {tuple(leaf.shape)}")
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        out.append(torch.from_numpy(arr).to(
            device=local.device if device is None else device,
            dtype=leaf.dtype))
    if placements is not None:
        out = shlib.place(tree_lib.unflatten(target, out), placements, mesh)
        return out, manifest
    out = [shlib.place_one(t, leaf.placements, leaf.device_mesh)
           if isinstance(leaf, DTensor) else t
           for t, leaf in zip(out, tree_lib.leaves(target))]
    return tree_lib.unflatten(target, out), manifest


def prune_old(ckpt_dir: str | Path, keep: int = 3) -> None:
    if not _writer():
        return
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
