"""Training one scan a step: the ``train`` command's own loop,
``cfun_tpu_torch/train/loop.py::train_model``, stopped by its ``on_step``
hook.

Before it builds anything ``run`` checks that ``train_model`` takes the
hook; a program without it ends the run at once with an error.

Set-up builds the port's libraries, holds the seed's pool of raw volumes
and their labels on the host (the configuration's sizes, the seed's
content; ``data/datasets.py::Dataset`` serves them by index) and starts
``train_model`` from the configuration's start weights, with the
traffic's feeder workers, its log in a temporary directory (removed
after).  The loop's feeder plans, rotates and draws from (seed, epoch),
as the ``train`` command does.  Its first ``warmup_steps`` steps are
set-up; the window then runs for the run's seconds and ends in a
synchronise once its last step is queued, so a step counts when it is
done.  ``volumes_per_s`` is the window's steps (one volume each) over its
seconds; a step whose total loss is not finite counts as failed.

A traced run profiles ``trace_steps`` steps after the loop's first
``trace_from`` instead (an epoch's worth, its end among them), with the
program's spans logged (``utils/profiling.py``: ``feed``, ``step`` with
``forward`` / ``backward`` / ``update``, ``epoch_end``, the feeder's
``item``), and reads the per-layer metrics from the profile, the span
log, each profiled step's own K1 call and the reference's FLOP count.

``correct``: two steps of the window are judged, one drawn from the seed
(the first step queued after a time drawn uniformly over the window)
and the window's last, a step later where the two would meet (a traced
run: one of the profiled steps but the last drawn from the seed, and
the last).  The program's step hands each to its observer
(``train_model``'s ``observers``, ``train/step.py::make_train_step``) as
it hands its gradients to the optimizer; the observer copies what the
judge needs into page-locked host memory, queued behind the work that
writes it, so that ``peak_mem_gib`` counts the program alone (two
throwaway judged steps of the warm-up allocate that memory in set-up).
Once the loop has ended and the program is freed, the plain reference
(``reference/train.py``) judges them (``compare_train.py``) against the
configuration's limits, one step at a time on the device.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import compare_train, harness, volumes
from portbench.reference import train_flops
from portbench.reference.model import RefConfig, set_plain_precision
from portbench.reference.train import flat

# the loop's spans whose device marks are not device work, and those open
# on its own thread that the device's idle time is put down to
SPANS = ("feed", "step", "forward", "backward", "update", "epoch_end")


def require_hook():
    """The program's ``train_model``, which must take ``on_step`` and
    ``observers``."""
    from cfun_tpu_torch.train import loop

    if not {"on_step", "observers"} <= set(
            inspect.signature(loop.train_model).parameters):
        raise SystemExit("portbench: this program's train_model takes no "
                         "on_step hook or no step observers; the train "
                         "cell cannot drive its loop")
    return loop.train_model


def _plain(v):
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


def port_config(spec: dict, model: dict):
    """The port's configuration from the ``train`` block's factory, stage
    and overrides, held to every number of the ``model`` block."""
    from cfun_tpu_torch import config as port

    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in spec.get("overrides", {}).items()}
    cfg = getattr(port, spec["factory"])(spec["stage"], **overrides)
    for key, want in model.items():
        got = _plain(getattr(cfg, key))
        if got != _plain(want):
            raise SystemExit(f"the port's {spec['factory']} gives {key} = "
                             f"{got!r}, the configuration file {want!r}")
    return cfg


def held_volumes(spec: dict, seed: int, device):
    """A ``Dataset`` over the seed's pool: [H, W, D, 1] float32 volumes and
    [H, W, D] int8 labels on the host."""
    from cfun_tpu_torch.data.datasets import Dataset

    pairs = [tuple(t.cpu().numpy() for t in volumes.GENERATORS[
        spec["generator"]]((spec["hw"][0], spec["hw"][1], int(d)), seed, i,
                           device))
        for i, d in enumerate(spec["depths"])]

    class Held(Dataset):
        def load_image(self, image_id):
            return pairs[image_id][0][..., None]

        def load_mask(self, image_id):
            return pairs[image_id][1]

    data = Held()
    for i in range(len(pairs)):
        data.add_image("synthetic", i, "")
    data.prepare()
    return data


BATCH = ("image", "rpn_match", "rpn_deltas", "gt_box_norm", "labels")


def _host(t):
    """``t`` copied off the device into page-locked memory, queued on the
    current stream behind the work that writes it (on the CPU: a clone)."""
    t = t.detach()
    return t.to("cpu", non_blocking=True) if t.is_cuda else t.clone()


def _keep(view, nms_only: bool) -> dict:
    """What a judged step needs of a ``StepView``, copied to the host (the
    K1 call, a few kilobytes, stays where it is)."""
    out = {"step": view.state.step, "nms": view.taken["nms"]}
    if nms_only:
        return out
    opt = view.state.opt_state
    mom = {p: opt.sgd.state.get(leaf, {}).get("momentum_buffer")
           for p, leaf in zip(opt.paths, opt.leaves)}
    t, d = view.taken["targets"], view.draws
    out.update(
        batch={k: _host(getattr(view.batch, k)) for k in BATCH},
        u_pos=_host(d.targets.u_pos), u_neg=_host(d.targets.u_neg),
        keep_masks=None if d.dropout_masks is None else [
            _host(m) for m in d.dropout_masks],
        parts=view.parts, targets=tuple(
            _host(x) for x in (t.rois, t.roi_valid, t.class_ids)),
        grads={p: _host(g) for p, g in view.grads.items()},
        before={p: _host(v) for p, v in flat(view.state.params).items()},
        momentum={p: None if m is None else _host(m)
                  for p, m in mom.items()},
        params=view.state.params, opt=opt)
    return out


def _after(rec: dict) -> None:
    """The judged step's parameters and momentum once its update is
    queued."""
    opt = rec.pop("opt")
    rec["after"] = {p: _host(v) for p, v in flat(rec.pop("params")).items()}
    rec["momentum_after"] = {
        p: _host(opt.sgd.state[leaf]["momentum_buffer"])
        for p, leaf in zip(opt.paths, opt.leaves)}


def judged(rec: dict, device) -> compare_train.Judged:
    """A kept step, back on ``device`` for the judge."""
    def dev(t):
        return t.to(device)

    b = {k: dev(v) for k, v in rec["batch"].items()}
    masks = rec["keep_masks"]
    return compare_train.Judged(
        step=rec["step"], image=b["image"], rpn_match=b["rpn_match"],
        rpn_deltas=b["rpn_deltas"], gt_box_norm=b["gt_box_norm"],
        labels=b["labels"], u_pos=dev(rec["u_pos"]), u_neg=dev(rec["u_neg"]),
        keep_masks=None if masks is None else [dev(m) for m in masks],
        nms=rec["nms"], targets=tuple(dev(x) for x in rec["targets"]),
        parts={k: float(v) for k, v in rec["parts"].items()},
        grads={p: dev(g) for p, g in rec["grads"].items()},
        before={p: dev(v) for p, v in rec["before"].items()},
        momentum={p: None if m is None else dev(m)
                  for p, m in rec["momentum"].items()},
        after={p: dev(v) for p, v in rec["after"].items()},
        momentum_after={p: dev(v)
                        for p, v in rec["momentum_after"].items()})


class Window:
    """The loop's ``on_step`` hook: warm-up, then the window (or the
    profiled steps), the judged steps' observers, and the stop."""

    def __init__(self, ctx, sync, spans, k1):
        self.ctx, self.sync = ctx, sync
        self.observers: Dict[int, object] = {}  # train_model's
        self.spans, self.k1 = spans, k1
        traffic = ctx.traffic
        self.warmup = traffic["warmup_steps"]
        self.trace_from = traffic["trace_from"]
        self.trace_steps = traffic["trace_steps"]
        rng = np.random.default_rng((ctx.seed, 7))
        # the drawn judged step: the first queued after a time drawn over
        # the window, or (traced) one of the profiled steps
        self.draw_s = float(rng.uniform(0.0, ctx.seconds))
        self.draw_i = int(rng.integers(self.trace_steps - 1))
        self.calls = 0
        self.first: Optional[int] = None
        self.stop_at: Optional[int] = None
        self.drawn: Optional[int] = None
        self.totals: List = []
        self.kept: Dict[int, dict] = {}
        self.nms_calls: List = []
        self.t_start = self.setup_s = None
        self.prof = None

    def watch(self, step: int, nms_only: bool = False):
        def observe(view):
            rec = _keep(view, nms_only)
            self.nms_calls.append(rec["nms"])
            if not nms_only:
                self.kept[step] = rec
        self.observers[step] = observe

    def __call__(self, step: int, metrics) -> bool:
        self.calls += 1
        if step in self.kept and "after" not in self.kept[step]:
            _after(self.kept[step])
        if self.warmup >= 3 and self.ctx.device.type == "cuda":
            # two throwaway judged steps in the warm-up: the page-locked
            # memory their copies take returns to the host allocator's
            # cache, where the window's judged steps find it
            if self.calls == self.warmup - 2:
                self.watch(step + 1)
                self.watch(step + 2)
            elif self.calls == self.warmup:
                self.sync()
                self.kept.clear()
                self.nms_calls.clear()
        if self.ctx.trace:
            return self._traced(step, metrics)
        if self.t_start is None:
            if self.calls == self.warmup:
                self._start(step)
            return False
        self.totals.append(metrics["total_loss"])
        if step == self.stop_at:
            return True
        elapsed = time.perf_counter() - self.t_start
        if self.drawn is None and elapsed >= self.draw_s:
            self.drawn = step + 1
            self.watch(self.drawn)
        if self.stop_at is None and elapsed >= self.ctx.seconds:
            # the last step comes after the drawn one, so that every run
            # holds the copies of two judged steps
            self.stop_at = max(step + 1, self.drawn + 1)
            self.watch(self.stop_at)
        return False

    def _start(self, step: int):
        self.sync()
        self.t_start = time.perf_counter()
        self.setup_s = self.t_start - self.ctx.t0
        self.first = step + 1
        self.k1.launches = 0
        # more judged steps, every third from the window's first, where
        # ``control_train.py`` asks for them
        for k in range(getattr(self.ctx, "judge_steps", 0)):
            self.watch(self.first + 3 * k)

    def _traced(self, step: int, metrics) -> bool:
        if self.t_start is None:
            if self.calls == self.trace_from:
                from torch.profiler import ProfilerActivity, profile

                from cfun_tpu_torch.utils.profiling import SpanLog

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA]
                    if self.ctx.device.type == "cuda" else [])
                self.stop_at = step + self.trace_steps
                self.drawn = step + 1 + self.draw_i
                for s in range(step + 1, self.stop_at + 1):
                    self.watch(s, nms_only=s not in (self.drawn,
                                                     self.stop_at))
                self.sync()
                self.prof = profile(activities=acts)
                self.spans.log = SpanLog()
                self.prof.start()
                self._start(step)
            return False
        self.totals.append(metrics["total_loss"])
        return step == self.stop_at


def run(ctx) -> dict:
    train_model = require_hook()
    import torch

    from cfun_tpu_torch import native
    from cfun_tpu_torch.ops import sorted_nms as k1
    from cfun_tpu_torch.utils.profiling import SpanRecorder

    device = ctx.device
    spec = ctx.config["train"]
    marks = {"import": time.perf_counter() - ctx.t0}
    if device.type == "cuda":
        from cfun_tpu_torch import _build

        _build.library()
    native.library()
    marks["build"] = time.perf_counter() - ctx.t0
    cfg = port_config(spec, ctx.config["model"])
    refcfg = RefConfig(ctx.config["model"])
    data = held_volumes(spec["volumes"], ctx.seed, device)
    marks["volumes"] = time.perf_counter() - ctx.t0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    spans = SpanRecorder()
    hook = Window(ctx, sync, spans, k1)
    weights = spec["weights"]
    if weights != "none":
        weights = os.path.join(ctx.root, weights)
    log_dir = tempfile.mkdtemp(prefix="portbench-train-")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            train_model(cfg, data, data, log_dir=log_dir, weights=weights,
                        seed=ctx.seed, num_workers=ctx.traffic["workers"],
                        device=device, on_step=hook, spans=spans,
                        observers=hook.observers)
        sync()
        wall = time.perf_counter() - hook.t_start
        if hook.prof is not None:
            hook.prof.stop()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    n = hook.stop_at - hook.first + 1
    launches = k1.launches
    totals = torch.stack(hook.totals).float().cpu()
    failed = int((~torch.isfinite(totals)).sum())
    device_desc = harness.device_info(device, ctx.cell["chips"])
    records = None
    if ctx.trace:
        reduction = harness.trace_reduction(hook.prof, set(SPANS))
        from portbench.spans import idle_by_span

        records = {
            "steps": n, "wall_s": wall, "busy_s": reduction["busy_s"],
            "k1_launches": launches,
            "kernel_s": reduction["kernel_s"],
            "idle_by_span": idle_by_span(hook.prof, SPANS),
            "spans": spans.log.take(),
            "k1_bound_s": sum(harness.nms_bound_s(v, idx, keep)
                              for _, v, _, idx, keep in hook.nms_calls),
            "flops": train_flops.step_flops(refcfg) * n,
            "peak_flops": harness.PEAK_BF16_FLOPS}
        brk = harness.breakdown(reduction)
        device_desc.update(busy_s=reduction["busy_s"], window_s=wall)
        hook.prof = None
        del reduction
    kept = [hook.kept.pop(s) for s in sorted(hook.kept)]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    set_plain_precision()
    # the controls ``control_train.py`` asks for, on the same steps
    precs = tuple(getattr(ctx, "controls", ()))
    readings, low = [], {prec: [] for prec in precs}
    for rec in kept:
        j = judged(rec, device)
        readings.append(compare_train.judge(refcfg, j))
        for prec in precs:
            low[prec].append(compare_train.judge(refcfg, j, prec))
        del j
    numbers = compare_train.worst(readings)
    controls = {prec: compare_train.worst(r) for prec, r in low.items()}
    correct, compared = compare_train.verdict(numbers, spec["limits"])
    if len(kept) < 2:
        correct = False  # a judged step went missing

    info = {"steps": n, "k1_launches": launches,
            "judged_steps": [rec["step"] for rec in kept],
            "positive_rois": [r["positive_rois"] for r in readings],
            "setup_marks_s": marks}
    if ctx.trace:
        metrics = {}
        for m in ctx.metrics:
            value = harness.metric_reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    else:
        brk = None
        values = {"setup_s": hook.setup_s, "volumes_per_s": n / wall,
                  "peak_mem_gib": device_desc["memory_peak_bytes"] / 2 ** 30}
        metrics = {m["name"]: (values[m["name"]], m["unit"])
                   for m in ctx.metrics}
        info["step_ms"] = 1e3 * wall / n
    return {"correct": correct, "attempted": n, "failed": failed,
            "metrics": metrics,
            "device": device_desc, "compared": compared, "breakdown": brk,
            "info": info, "setup_s": hook.setup_s, "readings": readings,
            "controls": controls}
