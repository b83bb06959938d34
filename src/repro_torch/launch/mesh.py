"""The production and local meshes (functions: importing this module
touches no device and no process group).

Port of ``repro/launch/mesh.py``. A mesh is a ``DeviceMesh`` over the
ranks of the default process group, which the caller owns: NCCL on the
card, gloo on the CPU, and for the dry-run the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``, which gives a world of
256 or 512 ranks in one process.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).

    Multi-pod: 2 pods x 256 = 512 ranks (pod, data, model); the ``pod`` axis
    carries data parallelism by default (the slowest links carry the least
    traffic), and optionally pipeline stages (see
    ``repro_torch.distributed.pipeline``). The default process group must
    hold exactly that many ranks.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, data: int = 1,
                    device_type: str = "cpu") -> DeviceMesh:
    """A small (data, model) mesh over the ranks of the default process
    group; a shape larger than the world shrinks as the reference's does
    (model 1, data at most the world size)."""
    n = dist.get_world_size()
    if model * data > n:
        model, data = 1, min(data, n)
    return DeviceMesh(device_type, [[data_i * model + m for m in range(model)]
                                    for data_i in range(data)],
                      mesh_dim_names=("data", "model"))
