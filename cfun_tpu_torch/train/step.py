"""One training step: forward, the six losses, the SGD update (port of
``cfun_tpu/train/step.py``).

The step runs on the device of the tensors it is given.  Optimizer
semantics are the JAX package's optax chain (reference model.py:1536-1545,
1640-1645): the global gradient norm clipped to 5.0, then weight decay
1e-4 on every parameter but the norm layers' (``decay_mask``), then SGD
with momentum 0.9 and learning rate 1e-3; with ``grad_accum_steps`` k > 1
the mean of k gradients is applied on every k-th step (optax
``MultiSteps``) and the parameters do not move in between.

Stage gating (``stage_flags``) is static: heart trains everything; LiTS
'beginning' trains detection only and skips the mask branch, 'together' /
'finetune' train the mask branch only.  The JAX package zeroes the frozen
leaves' gradients and updates; here only the leaves ``trainable_mask``
picks require a gradient and sit in the optimizer.  Frozen-BN statistics
never do.

Random draws (the ROI sampler's uniforms and the U-Net's dropout keep
masks, ``TrainDraws``) are taken before any compute, from a
``torch.Generator`` or passed in: a draw inside the checkpointed U-Net
would be drawn again when the backward pass recomputes it.

On a mesh (``parallel/mesh.py``) the forward takes the rank's ``Mesh``:
with ``cfg.shard_unet_spatial`` and more than one space rank, the mask
U-Net and its losses are split along the crops' D over the row's ranks
(``parallel/halo.py``).  ``batched_train_forward`` is the mean over
several volumes on one device, the dense reference of the mesh step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cfun_tpu_torch import nn
from cfun_tpu_torch import weights
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.models import cfun
from cfun_tpu_torch.models.heads import apply_classifier, apply_mask_head
from cfun_tpu_torch.models.unet3d import dropout_mask_shapes
from cfun_tpu_torch.ops.augment import (AugmentDraws, AugTrainBatch,
                                        device_augment, draw_augment)
from cfun_tpu_torch.ops.sample3d import roi_align
from cfun_tpu_torch.ops.sorted_nms import sorted_nms
from cfun_tpu_torch.parallel.halo import (shard_map_unet,
                                          sharded_mask_losses)
from cfun_tpu_torch.train import losses as L
from cfun_tpu_torch.train.targets import (TargetDraws, detection_targets,
                                          draw_targets)

LOSS_NAMES = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
              "mrcnn_bbox_loss", "mrcnn_mask_loss", "mrcnn_mask_edge_loss")


class TrainBatch(NamedTuple):
    """One molded training example (batch dim 1 on the image)."""
    # [1, 1, D, H, W]: the z-scored volume in the compute dtype, or int8
    # (the train wire, ``Config.train_wire_int8``)
    image: torch.Tensor
    rpn_match: torch.Tensor    # [A] int8 in {-1, 0, 1}
    rpn_deltas: torch.Tensor   # [A, 6] float32 (dense per-anchor targets)
    gt_box_norm: torch.Tensor  # [6] normalized whole-organ box
    # [D, H, W] int class labels, or [D, H, W/2] uint8 with two 4-bit
    # labels per byte along W (pack_labels_w)
    labels: torch.Tensor

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device) for t in self))


def pack_labels_w(labels: np.ndarray) -> np.ndarray:
    """Host-side: [.., W] int labels (< 16) -> [.., W/2] uint8, low nibble
    = left half of W, high nibble = right half."""
    half = labels.shape[-1] // 2
    l8 = labels.astype(np.uint8)
    return l8[..., :half] | (l8[..., half:] << 4)


def unpack_labels_w(packed: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`pack_labels_w` -> int32 [.., W]."""
    u = packed.to(torch.uint8)
    return torch.cat([u & 0xF, u >> 4], dim=-1).to(torch.int32)


class TrainDraws(NamedTuple):
    """A step's random draws: the ROI sampler's uniforms, the five
    dropout sites' keep masks (None without dropout) and, for an
    ``AugTrainBatch``, the device augment's RPN subsample uniforms."""
    targets: TargetDraws
    dropout_masks: Optional[List[torch.Tensor]]
    augment: Optional[AugmentDraws] = None


def draw_train(cfg: Config, generator: torch.Generator,
               device) -> TrainDraws:
    """Draw a step's randomness from ``generator`` (on its own device, in
    a fixed order: with ``cfg.augment_on_device`` the augment's two
    uniforms over the anchors, then the ROI sampler's positives' and
    negatives' uniforms, then the five keep masks) and place it on
    ``device``."""
    augment = None
    if cfg.augment_on_device:
        augment = draw_augment(cfg.num_anchors, generator, device)
    targets = draw_targets(cfg.post_nms_rois_training, generator, device)
    masks = None
    if stage_flags(cfg)[1] and cfg.unet_dropout_rate > 0.0:
        masks = [nn.dropout_keep(shape, cfg.unet_dropout_rate, generator,
                                 device=device)
                 for shape in dropout_mask_shapes(cfg.num_positive_rois,
                                                  cfg.unet_base_channels)]
    return TrainDraws(targets, masks, augment)


class TrainState(NamedTuple):
    params: dict
    opt_state: "SGDChain"
    step: int


def stage_flags(cfg: Config) -> Tuple[bool, bool, bool]:
    """(train_detection, train_mask, edge_loss_on) for this config/stage."""
    if cfg.name == "lits":
        if cfg.stage == "beginning":
            return True, False, False
        return False, True, True
    return True, True, cfg.stage == "finetune"


def trainable_mask(params, cfg: Config):
    """Tree of bools: which leaves the step updates."""
    train_detection, train_mask_branch, _ = stage_flags(cfg)

    def leaf_mask(path, _leaf):
        if path.endswith("/mean") or path.endswith("/var"):
            return False  # frozen-BN statistics are constants
        top = path.split("/")[0]
        if top in ("backbone", "fpn", "rpn", "classifier"):
            return train_detection
        if top == "mask":
            return train_mask_branch
        return True

    return weights._unflatten({p: leaf_mask(p, leaf) for p, leaf in
                               weights._leaves(params).items()})


def decay_mask(params):
    """Tree of bools: weight decay on everything except norm-layer
    parameters (the reference filters names containing 'bn',
    model.py:1538-1541)."""
    return weights._unflatten({p: "bn" not in p and "stem_bn" not in p
                               for p in weights._leaves(params)})


class SGDChain:
    """The optimizer of :func:`make_optimizer` over the trainable leaves:
    ``clip_by_global_norm -> add_decayed_weights(mask=decay_mask) ->
    sgd(momentum)`` (under ``MultiSteps`` when k > 1), as
    ``torch.optim.SGD`` with two parameter groups.

    The clip is optax's, ``g / norm * max_norm`` where ``norm >=
    max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm); torch's SGD
    adds the decay to the clipped gradient, as the chain does.  The
    accumulated gradient is optax's running mean ``acc + (g - acc) /
    (n + 1)``.

    Its state reads and writes as the JAX optimizer's state leaves
    (``state_leaves`` / ``load_state_leaves``, a checkpoint's ``opt/{i}``):
    the SGD momentum trace of every parameter in the JAX tree's order,
    and under ``MultiSteps`` first its two counters and after the traces
    its accumulator.  A momentum buffer is the trace (torch adds the
    decay before the momentum, as the chain does).  Frozen leaves have no
    state here: their traces are written as zeros (the JAX package's hold
    ``wd * p`` sums there, which never move a parameter) and dropped on
    read."""

    def __init__(self, cfg: Config, params):
        leaves = weights._leaves(params)
        train = weights._leaves(trainable_mask(params, cfg))
        decay = weights._leaves(decay_mask(params))
        self.paths = [p for p in leaves if train[p]]
        self.leaves = [leaves[p] for p in self.paths]
        # every leaf, trainable or not, in the JAX tree's order, and its
        # shape in the JAX layout
        self.tree_paths = weights.tree_order(params)
        self._jax_shapes = {p: weights.jax_shape(p, leaves[p].shape)
                            for p in self.tree_paths}
        self.gradient_step = 0
        groups = [
            {"params": [leaves[p] for p in self.paths if decay[p]],
             "weight_decay": cfg.weight_decay},
            {"params": [leaves[p] for p in self.paths if not decay[p]],
             "weight_decay": 0.0}]
        self.sgd = torch.optim.SGD([g for g in groups if g["params"]],
                                   lr=cfg.learning_rate,
                                   momentum=cfg.momentum, dampening=0.0,
                                   nesterov=False)
        self.max_norm = cfg.gradient_clip_norm
        self.k = cfg.grad_accum_steps
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def update(self, grads: Dict[str, torch.Tensor]) -> bool:
        """Take the gradients of the trainable leaves (by tree path; a
        missing one is zero) and step the parameters in place.  Returns
        whether they moved (False mid-accumulation)."""
        g = [grads[p] if grads.get(p) is not None else torch.zeros_like(x)
             for p, x in zip(self.paths, self.leaves)]
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(x) for x in g]
            n = self.mini_step
            self.acc = [a + (x - a) / (n + 1) for a, x in zip(self.acc, g)]
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            g, self.acc, self.mini_step = self.acc, None, 0
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        clip = norm < self.max_norm
        for leaf, x in zip(self.leaves, g):
            leaf.grad = torch.where(clip, x, x / norm * self.max_norm)
        self.sgd.step()
        for leaf in self.leaves:
            leaf.grad = None
        self.gradient_step += 1
        return True

    def host_state(self) -> "HostOptState":
        """A host copy of the optimizer's state (the momentum buffers and
        the accumulator as CPU tensors, the counters), whose
        ``state_leaves`` builds the checkpoint's leaves: a snapshot the
        next step's in-place updates do not touch."""
        def fetch(ts):
            return {p: t.detach().to("cpu", copy=True)
                    for p, t in ts if t is not None}

        return HostOptState(
            self.tree_paths, self._jax_shapes, self.k, self.mini_step,
            self.gradient_step,
            fetch((p, self.sgd.state.get(leaf, {}).get("momentum_buffer"))
                  for p, leaf in zip(self.paths, self.leaves)),
            fetch(zip(self.paths, self.acc or [])))

    def state_leaves(self) -> List[np.ndarray]:
        """The JAX optimizer's state leaves (see :class:`HostOptState`)."""
        return self.host_state().state_leaves()

    def load_state_leaves(self, stored: List[np.ndarray]) -> bool:
        """Restore from the JAX optimizer's state leaves (see
        :meth:`state_leaves`).  Returns False, and keeps the state as it
        is, when their count is not this optimizer's (the JAX package's
        ``checkpoint.load`` drops such a slot the same way)."""
        n = len(self.tree_paths)
        if len(stored) != (n if self.k == 1 else 2 + 2 * n):
            return False
        if self.k > 1:
            self.mini_step = int(stored[0])
            self.gradient_step = int(stored[1])
            traces, accs = stored[2:2 + n], stored[2 + n:]
        else:
            traces, accs = stored, None
        at = {p: i for i, p in enumerate(self.tree_paths)}
        for p, leaf in zip(self.paths, self.leaves):
            self.sgd.state[leaf]["momentum_buffer"] = weights._convert(
                p, traces[at[p]]).to(leaf.device)
        self.acc = None
        if accs is not None and self.mini_step > 0:
            self.acc = [weights._convert(p, accs[at[p]]).to(leaf.device)
                        for p, leaf in zip(self.paths, self.leaves)]
        return True


class HostOptState(NamedTuple):
    """A host copy of an ``SGDChain``'s state, by tree path."""
    tree_paths: List[str]
    jax_shapes: Dict[str, Tuple[int, ...]]
    k: int
    mini_step: int
    gradient_step: int
    traces: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]

    def state_leaves(self) -> List[np.ndarray]:
        """The JAX optimizer's state leaves, float32 numpy in the JAX
        layouts: every parameter's trace in the JAX tree's order (zeros
        for a frozen leaf, or before the first update), under
        ``MultiSteps`` after its two int32 counters and before its
        accumulator."""
        def per_leaf(ts):
            return [weights._to_jax_layout(p, ts[p]) if p in ts
                    else np.zeros(self.jax_shapes[p], np.float32)
                    for p in self.tree_paths]

        if self.k == 1:
            return per_leaf(self.traces)
        return ([np.asarray(self.mini_step, np.int32),
                 np.asarray(self.gradient_step, np.int32)]
                + per_leaf(self.traces) + per_leaf(self.acc))


def make_optimizer(cfg: Config, params) -> SGDChain:
    """The step's optimizer over ``params``' trainable leaves."""
    return SGDChain(cfg, params)


def train_forward(params, batch: TrainBatch, anchors: torch.Tensor,
                  cfg: Config, draws: Optional[TrainDraws] = None,
                  generator: Optional[torch.Generator] = None,
                  nms: cfun.NmsFn = sorted_nms, mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + all losses for one example on the batch's device.
    Returns (total, unweighted parts).

    ``draws``: the step's random draws; without them they are drawn from
    ``generator`` first (:func:`draw_train`).  ``nms``: the proposal
    layer's NMS (``ops/sorted_nms.py::sorted_nms``, the kernel on CUDA
    tensors).  ``mesh``: this rank's ``parallel.mesh.Mesh``; with
    ``cfg.shard_unet_spatial`` and ``mesh.space > 1`` the mask U-Net and
    its losses run split along D over the row's ranks
    (``parallel/halo.py``), and the results are the row's, the same on
    each of its ranks."""
    train_det, train_mask_branch, edge_on = stage_flags(cfg)
    dt = cfun.compute_dtype(cfg)
    image = batch.image
    device = image.device
    if draws is None:
        if generator is None:
            raise ValueError("train_forward needs draws or a generator")
        draws = draw_train(cfg, generator, device)

    if image.dtype == torch.int8:
        # the int8 train wire: dequantize on the device, in the compute
        # dtype
        image = image.to(dt) * (1.0 / cfg.wire_int8_scale)
    trunk = cfun.apply_trunk(params, image, cfg, remat=cfg.remat_trunk)
    proposals, valid = cfun.propose(
        trunk.rpn_logits[0].detach(), trunk.rpn_deltas[0].detach(), anchors,
        cfg, cfg.post_nms_rois_training, nms=nms)
    proposals = proposals.detach()

    labels = batch.labels
    if labels.shape[-1] == cfg.image_shape[2] // 2:
        labels = unpack_labels_w(labels)
    tgt = detection_targets(proposals, valid, batch.gt_box_norm, labels, cfg,
                            draws.targets, with_masks=train_mask_branch)

    zero = torch.zeros((), dtype=torch.float32, device=device)
    out = {name: zero for name in LOSS_NAMES}

    if train_det:
        out["rpn_class_loss"] = L.rpn_class_loss(batch.rpn_match,
                                                 trunk.rpn_logits[0])
        out["rpn_bbox_loss"] = L.rpn_bbox_loss(batch.rpn_match,
                                               batch.rpn_deltas,
                                               trunk.rpn_deltas[0])
        pooled = cfun.pyramid_roi_align(tgt.rois, trunk.p2[0], trunk.p3[0],
                                        cfg.pool_size)
        logits, deltas_pred = apply_classifier(params["classifier"], pooled,
                                               dtype=dt)
        out["mrcnn_class_loss"] = L.mrcnn_class_loss(tgt.class_ids,
                                                     tgt.roi_valid, logits)
        out["mrcnn_bbox_loss"] = L.mrcnn_bbox_loss(tgt.deltas, tgt.class_ids,
                                                   tgt.roi_valid, deltas_pred)

    if train_mask_branch:
        crops = roi_align(image[0], tgt.pos_rois, tuple(cfg.mask_pool_size))
        shard_spatial = (mesh is not None and cfg.shard_unet_spatial
                         and mesh.space > 1)
        if shard_spatial:
            def mask_fn(p, c):
                return shard_map_unet(
                    mesh, p["unet"], c, stage=cfg.stage,
                    dropout_rate=cfg.unet_dropout_rate,
                    dropout_masks=draws.dropout_masks, dtype=dt)
        else:
            def mask_fn(p, c):
                # the explicit up-conv and head forms: inside fwd + bwd
                # the phase forms hold more memory (the JAX package's
                # choice, train/step.py:189-198)
                return apply_mask_head(
                    p, c, stage=cfg.stage,
                    dropout_rate=cfg.unet_dropout_rate,
                    dropout_masks=draws.dropout_masks, dtype=dt,
                    head_impl="explicit", up_impl="explicit")

        if cfg.remat_unet:
            mask_logits = checkpoint(mask_fn, params["mask"], crops,
                                     use_reentrant=False)
        else:
            mask_logits = mask_fn(params["mask"], crops)
        if shard_spatial:
            # the targets, the CE and the edge maps stay split too
            mask_l, edge_l = sharded_mask_losses(
                mesh, tgt.masks, tgt.pos_valid, mask_logits, cfg,
                edge_on=edge_on)
            out["mrcnn_mask_loss"] = mask_l
            if edge_on:
                out["mrcnn_mask_edge_loss"] = edge_l
            return L.weighted_total(out, cfg), out
        out["mrcnn_mask_loss"] = L.mask_loss(tgt.masks, tgt.pos_valid,
                                             mask_logits, cfg)
        if edge_on:
            mask_probs = torch.softmax(mask_logits, dim=1)
            out["mrcnn_mask_edge_loss"] = L.mask_edge_loss(
                tgt.masks, tgt.pos_valid, mask_probs, cfg,
                per_class=(cfg.name == "lits"))

    return L.weighted_total(out, cfg), out


def train_forward_any(params, batch, anchors: torch.Tensor, cfg: Config,
                      draws: Optional[TrainDraws] = None,
                      generator: Optional[torch.Generator] = None,
                      nms: cfun.NmsFn = sorted_nms, mesh=None):
    """:func:`train_forward` that also takes an ``AugTrainBatch``
    (``cfg.augment_on_device``): the rotation, the re-z-score and the RPN
    targets run on the device first (``ops/augment.py``)."""
    if isinstance(batch, AugTrainBatch):
        if draws is None:
            if generator is None:
                raise ValueError("train_forward needs draws or a generator")
            draws = draw_train(cfg, generator, batch.image.device)
        if draws.augment is None:
            raise ValueError("an AugTrainBatch needs the augment's draws "
                             "(cfg.augment_on_device)")
        batch = device_augment(batch, anchors, cfg, draws.augment)
    return train_forward(params, batch, anchors, cfg, draws=draws,
                         generator=generator, nms=nms, mesh=mesh)


def unstack_batch(batch, i: int):
    """Item ``i`` of a batch stacked by ``parallel.mesh.stack_batches``."""
    return type(batch)(*(x[i] for x in batch))


def batched_train_forward(params, batch, anchors: torch.Tensor, cfg: Config,
                          draws: List[TrainDraws],
                          nms: cfun.NmsFn = sorted_nms
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean of :func:`train_forward_any` over a stacked batch (leading
    axis: volumes, ``parallel.mesh.stack_batches``), volume ``i`` with
    ``draws[i]``, on one device: (mean total, mean parts), the dense
    reference of the mesh step (``cfun_tpu/train/step.py:241-253``)."""
    n = len(draws)
    results = [train_forward_any(params, unstack_batch(batch, i), anchors,
                                 cfg, draws=draws[i], nms=nms)
               for i in range(n)]
    total = sum(t for t, _ in results) / n
    return total, {k: sum(p[k] for _, p in results) / n
                   for k in results[0][1]}


def loss_and_grads(params, batch: TrainBatch, anchors: torch.Tensor,
                   cfg: Config, draws: Optional[TrainDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   nms: cfun.NmsFn = sorted_nms, mesh=None):
    """:func:`train_forward_any` and the gradients of its total with respect
    to the trainable leaves: (total, parts, {tree path: gradient}), a
    leaf the loss does not reach getting zeros (its update is then the
    weight decay alone, as in the JAX package).  With a ``mesh`` the
    gradients are those of this rank's share of the step's objective,
    ``total / mesh.size`` (``parallel/mesh.py``); the total and the parts
    returned are the row's."""
    flat = weights._leaves(params)
    train = weights._leaves(trainable_mask(params, cfg))
    paths = [p for p in flat if train[p]]
    total, parts = train_forward_any(params, batch, anchors, cfg,
                                     draws=draws, generator=generator,
                                     nms=nms, mesh=mesh)
    leaves = [flat[p] for p in paths]
    share = total if mesh is None else total / mesh.size
    grads = torch.autograd.grad(share, leaves, allow_unused=True) \
        if total.requires_grad else [None] * len(leaves)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, {
        p: torch.zeros_like(x) if g is None else g
        for p, x, g in zip(paths, leaves, grads)}


def apply_update(cfg: Config, state: TrainState, grads: Dict[str, torch.Tensor],
                 total: torch.Tensor, parts: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The optimizer-update tail: the trainable leaves' gradients into the
    optimizer (frozen leaves have none), the parameters stepped in place,
    the metrics dict."""
    state.opt_state.update(grads)
    metrics = dict(parts, total_loss=total)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_train_step(cfg: Config, anchors):
    """Returns (init_state_fn, step_fn).

    ``init_state(params)`` marks the trainable leaves ``requires_grad``
    (the others not) and builds the optimizer.  ``step(state, batch,
    draws=None, generator=None, nms=sorted_nms)`` runs one step on the
    batch's device (a ``TrainBatch`` or an ``AugTrainBatch``) and returns
    (state, metrics)."""
    anchors = torch.as_tensor(np.asarray(anchors, np.float32))
    on_device: Dict[torch.device, torch.Tensor] = {}

    def init_state(params) -> TrainState:
        mask = weights._leaves(trainable_mask(params, cfg))
        for path, leaf in weights._leaves(params).items():
            leaf.requires_grad_(mask[path])
        return TrainState(params, make_optimizer(cfg, params), 0)

    def step(state: TrainState, batch: TrainBatch,
             draws: Optional[TrainDraws] = None,
             generator: Optional[torch.Generator] = None,
             nms: cfun.NmsFn = sorted_nms):
        device = batch.image.device
        if device not in on_device:
            on_device[device] = anchors.to(device)
        total, parts, grads = loss_and_grads(
            state.params, batch, on_device[device], cfg, draws=draws,
            generator=generator, nms=nms)
        return apply_update(cfg, state, grads, total, parts)

    return init_state, step
