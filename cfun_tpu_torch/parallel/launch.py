"""Start the ranks of a (data, space) mesh and run one function on each.

The JAX package drives its mesh from one controller process
(``jax.process_count() == 1``) or from one process a host under a
cluster launcher.  Here every rank is a process:

* with no launcher, :func:`launch` starts ``data * space`` processes with
  ``torch.multiprocessing`` (start method ``spawn``: a fresh interpreter
  that imports only this package and what the function needs).  They
  meet through a ``FileStore`` in a temporary directory of their own,
  never a fixed TCP port;
* under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
  this process is one rank: it joins that process group and runs the
  function itself (the counterpart of ``jax.process_count() > 1``,
  ``cfun_tpu/train/loop.py:127-147``).

Each rank builds its ``Mesh`` (``parallel/mesh.py::make_mesh``) and calls
``target(mesh, *args)``.  Its return value comes back to the caller
through a file in the run's directory (``torch.save``): kernel launch
counts, which are globals of each process, come back that way.  A rank
that raises fails the launch: the others are stopped and the error
raised.
Before it starts any rank, the caller's process builds the CUDA kernels
(``_build.library``) when a rank is on a card, so no two ranks build
into ``cfun_tpu_torch/_build/`` at once.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cfun_tpu_torch.parallel.mesh import (check_backend, default_backend,
                                          make_mesh, rank_devices)

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# the longest a collective (or the start) waits for the other ranks
TIMEOUT_S = 1800
# torch threads of a CPU rank: several ranks share the host's cores
CPU_RANK_THREADS = 2


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def _rank_main(rank: int, target: Callable, data: int, space: int,
               backend: str, devices, store: str, out_dir: str,
               timeout_s: float, args: tuple) -> None:
    """A spawned rank: join the group through the file store, build the
    mesh, run ``target``, write what it returns."""
    devs = rank_devices(data * space, devices)
    if devs[rank].type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=data * space,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(data, space, backend=backend, devices=devices)
        torch.save(target(mesh, *args),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(target: Callable, data: int, space: int = 1, args: tuple = (),
           *, devices: Union[str, Sequence] = "cuda",
           backend: Optional[str] = None,
           timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``target(mesh, *args)`` on every rank of a ``(data, space)``
    mesh; returns what each rank's call returned, in rank order (under
    ``torchrun``, this process's alone).

    ``devices``: 'cuda' (one card a rank), 'cpu', or one device a rank
    (``["cuda:0", "cuda:0"]`` with gloo rehearses two ranks on one card).
    ``backend``: by default NCCL on CUDA, gloo on the CPU.  ``timeout_s``:
    the longest a rank waits in a collective (or for the others to
    start) before it fails.  ``target`` and ``args`` are pickled to the
    ranks: ``target`` must be importable by
    name (a module's function), and nothing is shared but what ``args``
    carries.  Raises ValueError before any rank starts when the devices
    cannot hold the mesh (fewer cards than ranks, NCCL ranks sharing a
    card)."""
    world = data * space
    kind = torch.device(devices if isinstance(devices, (str, torch.device))
                        else devices[0]).type
    backend = backend or default_backend(kind)
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--mesh ({data}, {space}) needs {world} ranks; "
                             f"torchrun started {os.environ['WORLD_SIZE']}")
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method="env://",
                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(data, space, backend=backend, devices=devices)
        return [target(mesh, *args)]

    devs = rank_devices(world, devices)
    check_backend(backend, devs)
    if any(d.type == "cuda" for d in devs):
        from cfun_tpu_torch import _build

        _build.library()
    run_dir = tempfile.mkdtemp(prefix="cfun_mesh_")
    try:
        mp.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(target, data, space, backend, devices,
                  os.path.join(run_dir, "store"), run_dir, timeout_s, args))
        return [torch.load(os.path.join(run_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
