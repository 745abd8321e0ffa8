"""One process a device: the rank launcher of the port's collectives.

The JAX package needs no launcher, because one JAX process owns every chip
of its host and a sharded function is called once with a mesh. Here
collectives run between processes (``torch.distributed``), one rank a
device, and :func:`run_ranks` gives a caller in one process the JAX
package's calling form: it starts one rank for each listed device, runs
``fn(device, *args)`` in every rank inside an initialised process group, and
returns each rank's result to the caller.

- ranks start with the ``spawn`` method (CUDA forbids ``fork``), so ``fn``
  and its arguments travel by pickle: ``fn`` is a module-level function of
  the port, its arguments numpy arrays, configs and plain containers;
- the group meets at a ``file://`` store in a temporary directory;
- CUDA ranks use NCCL, CPU ranks gloo, with a finite ``timeout`` so that a
  hang fails the call instead of stalling it;
- each CUDA rank makes its device current before the group starts; CPU
  ranks share the host's cores between them;
- each rank starts with the caller's float32 matmul settings
  (:mod:`..precision` is process-wide);
- the CUDA kernels are built once, in the caller, before any rank starts;
- an exception in any rank is raised again in the caller (the other ranks
  are stopped), as the rank's own exception where it pickles.

A listed CUDA device that does not exist, or one listed twice, raises
before any rank starts. The kernel launches that ranks make are counted in
the ranks; :func:`run_ranks` adds each rank's counts to
:func:`rank_launch_counts` in the caller.

Callers already inside a process group (for example under ``torchrun``)
call the per-rank functions of :mod:`.shard`, :mod:`.train` and
:mod:`.graph_shard` directly instead.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DeviceSpec = Union[str, torch.device, Sequence[Union[str, torch.device]]]

# Bound of one collective (and of the group's start): a rank that hangs
# fails the call after it instead of stalling the caller.
TIMEOUT_S = 300.0
_KERNELS = ("graphconv_aggregate", "contact_degrees", "contact_map")

_rank_launches = dict.fromkeys(_KERNELS, 0)
_rank_launches_lock = threading.Lock()


def device_list(device: DeviceSpec) -> List[torch.device]:
    """``device`` as a list of torch devices of one type.

    Takes one device (``"cuda"``, ``"cuda:1"``, ``"cpu"``, a
    ``torch.device``), a comma-separated string (``"cuda:0,cuda:1"``, as
    the command line passes it) or a sequence. A CUDA device listed without
    an index among several is ``cuda:0``. CUDA devices must exist and be
    distinct; ``"cpu"`` may repeat (one CPU rank or replica each).
    """
    if isinstance(device, torch.device):
        parts: list = [device]
    elif isinstance(device, str):
        parts = [p.strip() for p in device.split(",") if p.strip()]
    else:
        parts = list(device)
    devs = [torch.device(p) for p in parts]
    if not devs:
        raise ValueError(f"no device in {device!r}")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices of one type only, got {device!r}")
    if devs[0].type == "cuda" and len(devs) > 1:
        devs = [torch.device("cuda", d.index or 0) for d in devs]
        n = torch.cuda.device_count()
        # a single device is checked where it is first used, as before
        missing = [str(d) for d in devs if d.index >= n]
        if missing:
            raise ValueError(f"{missing} do not exist ({n} CUDA devices)")
        if len(set(devs)) != len(devs):
            raise ValueError(f"a CUDA device is listed twice in {device!r}")
    return devs


def rank_launch_counts() -> dict:
    """Kernel launches made in ranks started by :func:`run_ranks`, summed
    over every rank of every call since the last reset."""
    with _rank_launches_lock:
        return dict(_rank_launches)


def reset_rank_launch_counts() -> None:
    with _rank_launches_lock:
        for k in _rank_launches:
            _rank_launches[k] = 0


def _own_launch_counts() -> dict:
    from metagenomic_deepfri_tpu_torch.ops import contact
    from metagenomic_deepfri_tpu_torch.ops import graphconv

    return {"graphconv_aggregate": graphconv.graphconv_aggregate.launches,
            "contact_degrees": graphconv.contact_degrees.launches,
            "contact_map": contact.contact_map_fused.launches}


def _precision_settings() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _rank_entry(rank: int, fn: Callable, devices: list, workdir: str,
                precision: tuple, args: tuple, kwargs: dict) -> None:
    """Body of one spawned rank: device, group, ``fn``, result file."""
    workdir = Path(workdir)
    try:
        torch.backends.cuda.matmul.allow_tf32 = precision[0]
        torch.backends.cudnn.allow_tf32 = precision[1]
        torch.set_float32_matmul_precision(precision[2])
        device = torch.device(devices[rank])
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.set_device(device)
        else:  # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // len(devices)))
        # NCCL is told the rank's card: guessed from the rank, it would be
        # wrong for a list such as cuda:2,cuda:3.
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"file://{workdir / 'store'}", rank=rank,
            world_size=len(devices), timeout=timedelta(seconds=TIMEOUT_S),
            **({"device_id": device} if cuda else {}))
        result = fn(device, *args, **kwargs)
        if cuda:
            torch.cuda.synchronize(device)
        with open(workdir / f"result{rank}.pkl", "wb") as f:
            pickle.dump((result, _own_launch_counts()), f)
    except BaseException as err:
        text = traceback.format_exc()
        try:
            payload = pickle.dumps((err, text))
        except Exception:  # noqa: BLE001 - an unpicklable exception
            payload = pickle.dumps((RuntimeError(text), text))
        (workdir / f"error{rank}.pkl").write_bytes(payload)
        raise
    # Only a rank that finished leaves the group: after an error the other
    # ranks may still wait in a collective, and the process ends anyway.
    dist.destroy_process_group()


def run_ranks(fn: Callable, devices: DeviceSpec, *args, **kwargs) -> list:
    """Run ``fn(device, *args, **kwargs)`` in one rank a device.

    Every rank runs inside an initialised process group of
    ``len(devices)`` ranks, rank ``r`` on ``devices[r]``. Returns the list
    of the ranks' return values, in rank order (each must pickle).
    """
    devs = device_list(devices)
    if devs[0].type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for ranks on {devices!r}")
        devs = [torch.device("cuda", d.index or 0) for d in devs]
        if devs[0].index >= torch.cuda.device_count():
            raise ValueError(f"{devs[0]} does not exist "
                             f"({torch.cuda.device_count()} CUDA devices)")
        from metagenomic_deepfri_tpu_torch.ops import _build

        _build.build_library()  # once here, not once a rank
    workdir = Path(tempfile.mkdtemp(prefix="mdf_ranks_"))
    try:
        try:
            mp.start_processes(
                _rank_entry, nprocs=len(devs), join=True,
                start_method="spawn",
                args=(fn, [str(d) for d in devs], str(workdir),
                      _precision_settings(), args, kwargs))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            for rank in range(len(devs)):
                path = workdir / f"error{rank}.pkl"
                if path.is_file():
                    rank_err, text = pickle.loads(path.read_bytes())
                    raise rank_err from RuntimeError(
                        f"rank {rank} of {len(devs)} on {devs[rank]} "
                        f"failed:\n{text}")
            raise RuntimeError(f"a rank of {len(devs)} failed") from err
        results = []
        for rank in range(len(devs)):
            result, launches = pickle.loads(
                (workdir / f"result{rank}.pkl").read_bytes())
            results.append(result)
            with _rank_launches_lock:
                for k, n in launches.items():
                    _rank_launches[k] += n
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
