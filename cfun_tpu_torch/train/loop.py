"""The epoch loop of training (the port of ``cfun_tpu/train/loop.py``):
the threaded feeder, the step, validation and checkpoints on the JAX
package's cadence, on one device or on a (data, space) mesh of ranks.

Schedule from the reference (model.py:1516-1573): one random rotation
angle an epoch, ``steps_per_epoch`` steps, validation and a checkpoint
every ``val_every_epochs`` epochs; a resumed run carries on its epoch
numbering from the checkpoint's metadata.

All training randomness derives from (seed, epoch), never from a stream
that runs across epochs, so a run stopped and resumed at epoch N replays
the uninterrupted one:

* the epoch's angle is ``default_rng((seed, epoch, 1)).integers(...)``
  and the feeder's plan (ids, target seeds) ``default_rng((seed,
  epoch))``: the JAX package's calls, so the same angles and items;
* the per-step draws (the ROI sampler's uniforms, the dropout masks, the
  device augment's RPN uniforms) come from a ``torch.Generator`` on the
  step's device seeded from ``(seed, epoch)``, drawn in step order by
  :func:`step_draws`; validation's from ``(seed + 0x5EED, epoch)``.  They
  cannot equal the JAX package's ``jax.random`` keys.

On a mesh (``mesh_spec=(data, space)``, ``parallel/``) every rank runs
this loop in its own process.  Each step takes ``data`` volumes, one a
mesh row: row ``r``'s feeder takes the strided shard ``r`` of the
epoch's plan, the items the JAX package's single-controller loop puts in
row ``r`` of its stacked batches; the ranks of a row build the same
items.  The per-step draws come from a generator seeded from (seed,
epoch, row), so a row's ranks draw the same.  The losses logged and the
validation loss are the means over the rows.  Only rank 0 prints and
writes checkpoints; each rank logs its metrics under a ``-rank{i}`` tag
(the JAX package's ``-host{i}``); every rank resumes from the same
checkpoint.

The host never waits on the device in a step but for the progress print
every 5 steps: the epoch's loss sums stay on the device, and the next
item's upload is issued from page-locked memory on a copy stream while
the step runs.  Validation forwards are the train forward without
gradients, dropout on (the JAX package's ``val_forward``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cfun_tpu_torch import native
from cfun_tpu_torch import weights as W
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.feeder import TrainFeeder
from cfun_tpu_torch.ops.anchors import config_anchors
from cfun_tpu_torch.parallel.launch import launch
from cfun_tpu_torch.parallel.mesh import (make_parallel_train_step,
                                          mean_over_rows)
from cfun_tpu_torch.train.step import (TrainDraws, draw_train,
                                       make_train_step, train_forward_any)
from cfun_tpu_torch.utils import checkpoint
from cfun_tpu_torch.utils.logging import MetricsLogger, progress

VAL_SEED_OFFSET = 0x5EED


def step_draws(cfg: Config, generator: torch.Generator,
               device) -> TrainDraws:
    """A step's random draws, train or validation, in the loop's order:
    every per-step draw of the loop is taken here."""
    return draw_train(cfg, generator, device)


def epoch_generator(seed: int, epoch: int, device,
                    row: Optional[int] = None) -> torch.Generator:
    """The generator of an epoch's per-step draws, on ``device``: a
    function of (seed, epoch) alone, and on a mesh of (seed, epoch, row)
    (the tag 3 keeps it apart from the plan's and the angle's NumPy
    streams)."""
    key = (seed, epoch, 3) if row is None else (seed, epoch, 3, row)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng(key).integers(2**62)))
    return gen


def epoch_angle(cfg: Config, seed: int, epoch: int) -> float:
    """The epoch's rotation angle in whole degrees (the JAX package's
    ``default_rng((seed, epoch, 1))`` draw)."""
    deg = int(cfg.augment_rotate_degrees)
    return float(np.random.default_rng((seed, epoch, 1)).integers(
        -deg, deg + 1))


class Uploader:
    """Puts feeder items (CPU tensors) on the device one step ahead.

    On CUDA each tensor is copied into page-locked memory and sent with a
    non-blocking copy on a side stream, so the copy overlaps the step
    already queued; :meth:`ready` makes the compute stream wait for it.
    With ``resident`` (``cfg.device_mold_cache``) the device copy of a
    tensor the feeder returns again (its cached mold) is kept and reused:
    after an item's first epoch its image and labels cross no copy.
    ``bytes`` counts what was sent."""

    def __init__(self, device, resident: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.resident: Optional[Dict[int, Tuple]] = {} if resident else None
        self.bytes = 0

    def _send(self, t):
        if not isinstance(t, torch.Tensor) or not self.cuda:
            return t
        if self.resident is not None:
            kept = self.resident.get(id(t))
            if kept is not None:
                return kept[1]
        self.bytes += t.numel() * t.element_size()
        with torch.cuda.stream(self.stream):
            out = t.pin_memory().to(self.device, non_blocking=True)
        if self.resident is not None:
            # the host tensor is kept too, so its id stays its own
            self.resident[id(t)] = (t, out)
        return out

    def put(self, item):
        if item is None:
            return None
        return type(item)(*(self._send(t) for t in item))

    def ready(self, batch):
        """The batch, safe to use on the current stream."""
        if self.cuda:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self.stream)
            for t in batch:
                if isinstance(t, torch.Tensor):
                    t.record_stream(main)
        return batch


def train_model(cfg: Config, train_dataset, val_dataset,
                log_dir: str = "./logs", weights: Optional[str] = None,
                epochs: Optional[int] = None, seed: int = 0,
                num_workers: int = 8,
                mesh_spec: Optional[Tuple[int, int]] = None,
                device="cuda", backend: Optional[str] = None,
                devices=None) -> Optional[str]:
    """Train to ``epochs`` (default ``cfg.epochs``) on ``device``;
    returns the final checkpoint's path.  ``weights``: a checkpoint to
    start from (the port's or the JAX package's ``.npz``, which resumes
    the optimizer and the epoch, or a reference PyTorch checkpoint), or
    None / 'none' for ``weights.init_params(cfg, seed)``.

    ``mesh_spec=(data, space)``: train on ``data * space`` ranks
    (``parallel/launch.py``; module docstring): one card a rank under
    NCCL on CUDA, gloo ranks on the CPU with ``device='cpu'``.
    ``backend`` and ``devices`` (one device a rank, e.g. ``["cuda:0",
    "cuda:0"]`` with ``backend='gloo'`` to rehearse on one card) override
    that; nothing changes the backend or the devices by itself, and fewer
    cards than ranks raise ValueError before any rank starts.  Under
    ``torchrun`` this process is one rank, and ranks other than 0 return
    None."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; train on the CPU with "
                           "device='cpu'")
    args = (cfg, train_dataset, val_dataset, log_dir, weights, epochs, seed,
            num_workers)
    if mesh_spec is None:
        return _train(None, device, *args)
    if cfg.device_mold_cache:
        raise ValueError(
            "device_mold_cache is a single-device optimization: the mesh "
            "batch path stacks host rows (and multi-controller assembly "
            "requires process-local host arrays)")
    # the feeder's host ops, built here once rather than by every rank
    native.library()
    return launch(_train_rank, *mesh_spec, args=args,
                  devices=devices or device.type, backend=backend)[0]


def _train_rank(mesh, *args) -> Optional[str]:
    return _train(mesh, mesh.device, *args)


def _train(mesh, device, cfg: Config, train_dataset, val_dataset,
           log_dir: str, weights: Optional[str], epochs: Optional[int],
           seed: int, num_workers: int) -> Optional[str]:
    """The loop on ``device``, alone (``mesh`` None) or as one rank of
    ``mesh``; the final checkpoint's path (None on ranks other than 0)."""
    main = mesh is None or mesh.rank == 0
    row = None if mesh is None else mesh.data_index
    epochs = epochs or cfg.epochs
    anchors = config_anchors(cfg)
    if mesh is None:
        init_state, step = make_train_step(cfg, anchors)
    else:
        init_state, step = make_parallel_train_step(cfg, anchors, mesh)
    state = init_state(W.to_device(W.init_params(cfg, seed=seed), device))
    start_epoch = 0
    if weights and weights.lower() != "none" and (
            os.path.exists(weights) or os.path.exists(weights + ".npz")):
        params, _, meta = checkpoint.load_any(weights, cfg, state.params,
                                              state.opt_state)
        loaded = W._leaves(params)
        with torch.no_grad():
            for path, leaf in W._leaves(state.params).items():
                leaf.copy_(loaded[path])
        state = state._replace(step=int(meta.get("step", 0)))
        start_epoch = int(meta.get("epoch", 0))
        if main:
            print(f"Resumed from {weights} at epoch {start_epoch} "
                  f"({meta.get('source', 'npz')})", flush=True)

    tag = "" if mesh is None or mesh.size == 1 else f"-rank{mesh.rank}"
    run_dir = os.path.join(log_dir, cfg.name,
                           time.strftime("%Y-%m-%d_%H-%M-%S") + tag)
    os.makedirs(run_dir, exist_ok=True)
    logger = MetricsLogger(run_dir)
    shard = {} if mesh is None else dict(shard_index=mesh.data_index,
                                         num_shards=mesh.data)
    if mesh is not None and main:
        print(f"Mesh training: data {mesh.data} x space {mesh.space} "
              f"({mesh.data} volumes/step, {mesh.backend} on "
              f"{mesh.device.type})", flush=True)
    feeder = TrainFeeder(train_dataset, cfg, anchors, seed=seed,
                         num_workers=num_workers, **shard)
    val_feeder = TrainFeeder(val_dataset, cfg, anchors, seed=seed + 1,
                             num_workers=max(2, num_workers // 2), **shard)
    up = Uploader(device, resident=cfg.device_mold_cache)
    anchors_dev = torch.from_numpy(anchors).to(device)
    ckpt_path = os.path.join(run_dir, "model")
    total_sum = float("nan")

    try:
        for epoch in range(start_epoch + 1, epochs + 1):
            t0 = time.time()
            angle = epoch_angle(cfg, seed, epoch)
            gen = epoch_generator(seed, epoch, device, row)
            items = feeder.epoch(angle, cfg.steps_per_epoch,
                                 epoch_index=epoch)
            sent, wait = up.bytes, 0.0
            tw = time.perf_counter()
            pending = up.put(next(items, None))
            wait += time.perf_counter() - tw
            sums, i = None, 0
            while pending is not None:
                cur = up.ready(pending)
                draws = step_draws(cfg, gen, device)
                state, metrics = step(state, cur, draws)  # queued
                # while the step runs: the next item (its worker may still
                # be molding it) and its upload
                tw = time.perf_counter()
                pending = up.put(next(items, None))
                wait += time.perf_counter() - tw
                sums = metrics if sums is None else {
                    k: sums[k] + v for k, v in metrics.items()}
                if main and ((i + 1) % 5 == 0
                             or i + 1 == cfg.steps_per_epoch):
                    progress(i + 1, cfg.steps_per_epoch,
                             {"loss": float(metrics["total_loss"])},
                             prefix=f"epoch {epoch} ")
                i += 1
            keys = sorted(sums)
            fetched = {k: v / cfg.steps_per_epoch for k, v in zip(
                keys, torch.stack([sums[k] for k in keys]).tolist())}
            total_sum = fetched.pop("total_loss")
            times = feeder.pop_times()
            item_ms = {k: 1e3 * float(np.mean([t[k] for t in times]))
                       for k in times[0]} if times else {}
            logger.log({"epoch": epoch, "angle": angle, "loss": total_sum,
                        **fetched, "epoch_s": round(time.time() - t0, 2),
                        "steps": i, "feeder_wait_s": wait,
                        "feeder_item_ms": item_ms,
                        "h2d_bytes": up.bytes - sent})
            if main:
                print(f"Epoch {epoch}/{epochs} loss {total_sum:.5f} "
                      f"({time.time() - t0:.1f}s)", flush=True)

            if epoch % cfg.val_every_epochs == 0:
                val_loss = 0.0
                vgen = epoch_generator(seed + VAL_SEED_OFFSET, epoch, device,
                                       row)
                steps = min(cfg.validation_steps, val_dataset.num_images)
                with torch.no_grad():
                    for item in val_feeder.epoch(angle, steps,
                                                 epoch_index=epoch):
                        batch = up.ready(up.put(item))
                        total, _ = train_forward_any(
                            state.params, batch, anchors_dev, cfg,
                            step_draws(cfg, vgen, device), mesh=mesh)
                        if mesh is not None:
                            total = mean_over_rows(total, mesh)
                        val_loss += float(total) / steps
                val_feeder.pop_times()
                record = {"epoch": epoch, "val_loss": val_loss}
                if main:
                    t_save = time.perf_counter()
                    # only the fetch to the host blocks here; the write
                    # overlaps the next epoch
                    checkpoint.save_async(ckpt_path, state.params,
                                          epoch=epoch, step=state.step,
                                          opt_state=state.opt_state,
                                          meta={"name": cfg.name,
                                                "stage": cfg.stage,
                                                "loss": total_sum,
                                                "val_loss": val_loss})
                    record["save_async_s"] = time.perf_counter() - t_save
                    print(f"  val loss {val_loss:.5f}", flush=True)
                logger.log(record)
    finally:
        feeder.close()
        val_feeder.close()
        logger.close()
        # never hide the loop's own exception behind a writer failure
        checkpoint.flush(raise_errors=False)

    if not main:
        return None
    meta = {"name": cfg.name, "stage": cfg.stage}
    if total_sum == total_sum:  # NaN <=> no epoch ran: no loss
        meta["loss"] = total_sum
    return checkpoint.save(ckpt_path, state.params, epoch=epochs,
                           step=state.step, opt_state=state.opt_state,
                           meta=meta)
