"""The ('data', 'space') mesh over ``torch.distributed`` ranks and the
data + spatially parallel training step (port of
``cfun_tpu/parallel/mesh.py``).

One process per rank (``parallel/launch.py`` starts them).  Rank ``r`` of
a ``(data, space)`` mesh sits at ``data_index = r // space``, ``space_index
= r % space``: the ``(data, space)`` reshape of the JAX package's device
list.  Each mesh row (the ``space`` ranks of one ``data_index``) trains
one volume; a row's ranks split the trunk along H and, with
``cfg.shard_unet_spatial``, the mask U-Net and its losses along the crops'
D (``parallel/halo.py``), and run the rest of the step replicated, with
the same inputs and draws.  Parameters and optimizer state are
replicated: every rank applies the same update.

The JAX package expresses all of this as shardings of one jitted program
(``batch_sharding``, ``aug_batch_sharding``, GSPMD's halo exchanges along
H).  Here each rank holds its own row's batch, so those two functions have
no counterpart; in their place the training loop gives each row its own
feeder shard (``train/loop.py``), and the step all-reduces the gradients
itself.  GSPMD shards the trunk along H under ``batch_sharding``; here
``models/cfun.py::apply_trunk(group=...)`` splits it the same way, with
halo exchanges along H, and gathers its maps whole before the proposals.

The step's gradient rule (``parallel/halo.py``): every rank
backpropagates its share of the mean objective over the step's volumes,
``total / (data * space)`` where ``total`` is its row's loss, computed
through differentiable collectives and so the same on the row's ranks;
the shares sum to the mean, and the gradients are summed over all ranks.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from cfun_tpu_torch import weights
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.batch import AugTrainBatch, TrainBatch
from cfun_tpu_torch.ops.sorted_nms import sorted_nms
from cfun_tpu_torch.train import step as tstep

# gradients all-reduced per call, at most (64 MiB of float32): a few flat
# buckets instead of one call a leaf
BUCKET_ELEMENTS = 1 << 24


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, space) mesh: its coordinates, the
    process group of its mesh column (``data_group``: the ranks of its
    ``space_index``, one a row) and of its row (``space_group``), and its
    device."""
    data: int
    space: int
    rank: int
    data_index: int
    space_index: int
    data_group: object
    space_group: object
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return self.data * self.space


def default_backend(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_devices(world: int, devices: Union[str, Sequence] = "cuda"
                 ) -> List[torch.device]:
    """The device of each of ``world`` ranks on this host: for a device
    type ('cuda' / 'cpu'), one card per rank (``cuda:0`` .. ``cuda:world -
    1``) or the CPU for all; else ``devices`` itself, one a rank.  Raises
    ValueError when there are fewer cards than ranks, naming how many are
    visible."""
    if isinstance(devices, (str, torch.device)):
        kind = torch.device(devices).type
        if kind == "cpu":
            return [torch.device("cpu")] * world
        out = [torch.device("cuda", i) for i in range(world)]
    else:
        out = [torch.device(d) for d in devices]
        if len(out) != world:
            raise ValueError(f"{len(out)} devices given for {world} ranks")
    need = [d for d in out if d.type == "cuda"]
    visible = torch.cuda.device_count() if need else 0
    if need and max(d.index or 0 for d in need) >= visible:
        raise ValueError(
            f"make_mesh: {world} rank(s) need {len(set(need))} CUDA "
            f"device(s) but only {visible} CUDA device(s) are visible; one "
            "rank a card (NCCL), or train on the CPU (device 'cpu')")
    return out


def ranks_on_host() -> int:
    """The ranks of the default process group on this host: torchrun's
    local world, or the whole group (``parallel/launch.py`` starts every
    rank on this host); 1 without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def check_backend(backend: str, devices: Sequence[torch.device]) -> None:
    """NCCL takes one card a rank and no CPU rank; gloo takes either (the
    rehearsal of several ranks on one card)."""
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("the NCCL backend takes CUDA devices only; use "
                         "gloo for CPU ranks")
    if len(set(devices)) < len(devices):
        raise ValueError(
            f"NCCL takes one card a rank, and {len(devices)} ranks would "
            f"share {sorted({str(d) for d in devices})}; rehearse several "
            "ranks on one card with backend 'gloo'")


def make_mesh(data: int, space: int = 1, *, backend: Optional[str] = None,
              devices: Union[str, Sequence] = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over the initialized default process
    group of ``data * space`` ranks (``parallel/launch.py``).  ``devices``:
    a device type or one device a rank (:func:`rank_devices`);
    ``backend``: the process group's, by default that of the device type.
    Every rank calls this with the same arguments: the mesh's groups are
    made collectively."""
    world = data * space
    if dist.get_world_size() != world:
        raise ValueError(f"make_mesh: ({data}, {space}) needs {world} ranks; "
                         f"the process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    # this host's ranks: all of them, or torchrun's local ones
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    devs = rank_devices(ranks_on_host(), devices)
    backend = backend or dist.get_backend()
    check_backend(backend, devs)
    data_groups = [dist.new_group([d * space + s for d in range(data)])
                   for s in range(space)]
    space_groups = [dist.new_group([d * space + s for s in range(space)])
                    for d in range(data)]
    device = devs[local_rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(data, space, rank, rank // space, rank % space,
                data_groups[rank % space], space_groups[rank // space],
                device, backend)


def put_replicated(tree, mesh: Mesh):
    """Every tensor leaf of ``tree`` (on the mesh's device) set in place to
    rank 0's, leaf by leaf in tree-path order.  Returns ``tree``."""
    with torch.no_grad():
        for _, leaf in sorted(weights._leaves(tree).items()):
            dist.broadcast(leaf, src=0)
    return tree


def stack_batches(batches: Sequence[Union[TrainBatch, AugTrainBatch]]):
    """Per-volume ``TrainBatch`` / ``AugTrainBatch`` items stacked along a
    new leading axis (tensor fields stacked, the others as tuples), the
    item type kept: the input of ``train/step.py::
    batched_train_forward``."""
    return type(batches[0])(*(
        torch.stack(list(x)) if isinstance(x[0], torch.Tensor) else tuple(x)
        for x in zip(*batches)))


def all_reduce_gradients(grads: Dict[str, torch.Tensor], group=None
                         ) -> Dict[str, torch.Tensor]:
    """Every gradient summed over ``group`` (default: all ranks), in
    sorted path order through a few flat buckets of at most
    ``BUCKET_ELEMENTS``, each of one dtype."""
    paths = sorted(grads)
    out: Dict[str, torch.Tensor] = {}
    bucket: List[str] = []

    def flush():
        flat = torch.cat([grads[p].reshape(-1) for p in bucket])
        dist.all_reduce(flat, group=group)
        for p, piece in zip(bucket, flat.split([grads[p].numel()
                                                for p in bucket])):
            out[p] = piece.view_as(grads[p])
        bucket.clear()

    size = 0
    for p in paths:
        g = grads[p]
        if bucket and (size + g.numel() > BUCKET_ELEMENTS
                       or g.dtype != grads[bucket[0]].dtype):
            flush()
            size = 0
        bucket.append(p)
        size += g.numel()
    if bucket:
        flush()
    return out


def mean_over_rows(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row's replicated ``values`` averaged over the mesh's rows (the
    data group), the same on every rank."""
    out = values.detach().clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out / mesh.data


class _Timer:
    """Elapsed time of a region on the device's stream (CUDA events, read
    later, no synchronization in the region) or on the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: List = []

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((self._start, end))
        else:
            self.spans.append(time.perf_counter() - self._start)

    def pop_ms(self) -> List[float]:
        """The recorded spans in ms (synchronizes on CUDA), then none."""
        if self.cuda:
            torch.cuda.synchronize()
            out = [a.elapsed_time(b) for a, b in self.spans]
        else:
            out = [1e3 * s for s in self.spans]
        self.spans = []
        return out


def make_parallel_train_step(cfg: Config, anchors, mesh: Mesh):
    """(init_state, step) of the mesh's training step.

    ``init_state(params)``: the parameters (a tree on the mesh's device)
    set to rank 0's, then ``train/step.py::make_train_step``'s state.
    ``step(state, batch, draws=None, generator=None, nms=sorted_nms)``:
    this row's volume (``batch`` and ``draws`` the same on the row's
    ranks); the local ``loss_and_grads`` of its share of the objective,
    the gradients summed over all ranks, then the same ``SGDChain.update``
    on every rank (the global-norm clip sees the summed gradients).
    Returns (state, metrics): the loss parts and the total averaged over
    the rows, the same on every rank.  ``step.allreduce_ms()`` pops the
    gradient all-reduce's time in each step since the last call."""
    init_plain, _ = tstep.make_train_step(cfg, anchors)
    anchors_dev = torch.as_tensor(np.asarray(anchors, np.float32)).to(
        mesh.device)
    timer = _Timer(mesh.device)

    def init_state(params) -> tstep.TrainState:
        return init_plain(put_replicated(params, mesh))

    def step(state: tstep.TrainState, batch, draws=None, generator=None,
             nms=sorted_nms):
        total, parts, grads = tstep.loss_and_grads(
            state.params, batch, anchors_dev, cfg, draws=draws,
            generator=generator, nms=nms, mesh=mesh)
        with timer:
            grads = all_reduce_gradients(grads)
        names = sorted(parts)
        mean = mean_over_rows(torch.stack([total] + [parts[k]
                                                     for k in names]), mesh)
        return tstep.apply_update(cfg, state, grads, mean[0],
                                  dict(zip(names, mean[1:])))

    step.allreduce_ms = timer.pop_ms
    return init_state, step
