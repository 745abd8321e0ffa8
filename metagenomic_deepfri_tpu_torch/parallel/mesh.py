"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``metagenomic_deepfri_tpu/parallel/mesh.py:18-81``. The JAX
mesh is a grid of the chips one process owns; here every device is the rank
of one process (started by :mod:`.launch`, or by a launcher such as
``torchrun``), and the mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` over those ranks with named
``data`` and ``model`` axes. Ranks fill the grid row by row, as the JAX
package reshapes its device list: rank ``r`` sits at data index
``r // model_parallel`` and model index ``r % model_parallel``.

Collectives over one axis run on that axis's process group
(:func:`axis_group`); :func:`axis_rank` and :func:`axis_size` read a rank's
place on it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

_DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu"}


def _mesh_device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: given, or named by the process group's
    backend (NCCL ranks are CUDA ranks, gloo ranks CPU ranks)."""
    if device_type is not None:
        return device_type
    backend = dist.get_backend()
    try:
        return _DEVICE_TYPES[backend]
    except KeyError:
        raise ValueError(f"no device type for backend {backend!r}; pass "
                         "device_type") from None


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1,
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A 2-D (data, model) mesh over the ranks of the process group.

    Args:
        n_devices: how many ranks the mesh spans (default: every rank). A
            mesh spans the whole group, so any other count raises; start as
            many ranks as the mesh has devices (:func:`.launch.run_ranks`
            takes one device a rank).
        model_parallel: size of the model (tensor) axis; must divide the
            device count. The data axis gets the rest; 1 is pure data
            parallelism.
        axis_names: names of the (data, model) axes.
        device_type: "cuda" or "cpu" (default: from the group's backend).

    Raises the JAX function's ``ValueError`` s: more devices requested than
    there are, and a model axis that does not divide them.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} visible")
    if n != world:
        raise ValueError(f"requested {n} devices of a {world}-rank group: a "
                         "mesh spans every rank")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices")
    return init_device_mesh(_mesh_device_type(device_type),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def make_pod_mesh(model_parallel: int = 1,
                  axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
                  device_type: Optional[str] = None) -> DeviceMesh:
    """Multi-host mesh: the model axis stays inside a host, the data axis
    spans hosts.

    A host's ranks are ``LOCAL_WORLD_SIZE`` consecutive ranks (as
    ``torchrun`` numbers them; without the variable, the whole group is one
    host). The model axis must divide that count, so that its collectives
    ride the host's NVLink and only the data axis's gradient all-reduce
    crosses hosts. On one host this is :func:`make_mesh`.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs an initialised process group")
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_local % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide local device "
            f"count {n_local} (model axis must not cross hosts)")
    # Row-major rank order keeps each model group inside one host whenever
    # model_parallel divides the host's rank count.
    return make_mesh(model_parallel=model_parallel, axis_names=axis_names,
                     device_type=device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)
