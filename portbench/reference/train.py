"""The plain reference of one CFUN heart training step, in PyTorch and
float32 (TF32 off): the forward, the six losses, their gradients by
autograd and the optimizer, written from the published description
(Wuziyi616/CFUN ``heart_main.py:26-174``, ``model.py``) as plain
``torch`` operations.  It imports nothing of the program under test; it
takes the served reference's trunk, RoIAlign and classifier
(``reference/model.py``) and writes the rest anew.

A step is judged at the program's own choices, as a served token is
judged by the reference's logits at the token the program chose: the
reference takes the program's batch (its molded image, RPN targets, GT
box and labels), its K1 call (the 1000 score-sorted boxes and the keep
set), the sampler's uniforms and the dropout keep masks the step drew,
and checks each choice by the published rule before it computes with
it:

* ``keep_set_violations``: the keep set of a greedy NMS of the program's
  own boxes at the threshold, box by box;
* ``sample_targets``: the detection-target sampler (model.py:414-563),
  driven by the program's uniforms;
* ``rpn_target_violations``: the anchors' RPN match against the published
  rule (model.py:1090-1181), on the reference's own IoUs.

The proposal layer before its NMS is computed anew
(``pre_nms_boxes``: the reference's own scores, deltas and anchors), for
the judge to hold the program's 1000 boxes against.

Departures from the published description, each the program's too:

* the reference matches the proposals against NUM_CLASSES-1 copies of the
  one whole-organ box and gives every positive the first class; here the
  one box is matched and positives are class 1 (model.py:1076);
* the sampler is fixed-capacity: positives up to ``int(R * ratio)``
  (``num_positive_rois``), picked as the largest of the step's uniforms
  (ties to the lower index), negatives up to ``R`` less that capacity,
  limited to the published quota ``int(pos / ratio - pos)``, computed in
  float32 and truncated;
* RPN deltas are dense per anchor (zero but at the positives), where the
  reference packs the positives' rows; the loss is the same mean;
* the edge loss takes the gradient magnitude of gx, gy and gz, where the
  reference repeats gx (model.py:969-972); it is off at 'beginning', as
  published (model.py:995-998);
* the U-Net's up-convolutions are a nearest upsample and a 3^3 conv, and
  its channel dropout (Dropout3d, mask_branch.py:19) takes the keep masks
  the program drew, one per site and crop;
* the optimizer is ``clip_by_global_norm`` (g / norm * max where norm >=
  max), then weight decay on every parameter whose path holds no 'bn'
  (model.py:1538-1541), then SGD with momentum (the buffer starts at the
  first gradient), as the reference's ``torch.optim.SGD`` with a clip.

``prec="fp8"`` runs every convolution and matrix product of the forward
from float8 (e4m3) copies of its operands (``reference/model.py``): the
control of the comparison.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import (RefConfig, _shape6, _top, anchors,
                                       apply_deltas, classifier, clip,
                                       conv3d, instance_norm, iou_matrix,
                                       lrelu, pyramid_pool, roi_align,
                                       trunk, up2)

# a greedy NMS decision whose IoU lies this close to the threshold is one
# that float32 rounding may take either way: it is not counted
NMS_TIE = 1e-6
BBOX_EDGE = 1e-6  # the sizes' floor in the box refinement


def positive_capacity(cfg: RefConfig) -> int:
    return max(1, int(cfg.train_rois_per_image * cfg.roi_positive_ratio))


def unpack_labels(labels: torch.Tensor, width: int) -> torch.Tensor:
    """The label volume [D, H, W] as int64: two 4-bit labels a byte along
    W (low nibble the left half, high the right half) where the wire
    packs them, else as it is."""
    if labels.shape[-1] == width:
        return labels.long()
    u = labels.to(torch.uint8)
    return torch.cat([u & 0xF, u >> 4], dim=-1).long()


# ---- the program's choices, checked -----------------------------------------

def keep_set_violations(boxes, valid, threshold, k, idx, keep) -> int:
    """Boxes whose place in the program's keep set (``idx`` / ``keep``)
    breaks greedy NMS over its score-sorted ``boxes``: a kept box that is
    invalid, out of order or suppressed by an earlier kept one (IoU above
    the threshold), and a valid box that the walk reaches (up to the
    ``k``-th kept box, or to the end) and neither keeps nor suppresses.
    An IoU within ``NMS_TIE`` of the threshold may go either way."""
    boxes = boxes.float()
    n = boxes.shape[0]
    got = idx[keep].long().cpu().tolist()
    valid_c = valid.cpu().numpy()
    bad = sum(1 for a, b in zip(got, got[1:]) if b <= a)
    bad += sum(1 for i in got if not (0 <= i < n and valid_c[i]))
    got = [i for i in got if 0 <= i < n]
    iou = iou_matrix(boxes, boxes).cpu().numpy()
    kept_set = set(got)
    for j, i in enumerate(got):
        if j and iou[got[:j], i].max() > threshold + NMS_TIE:
            bad += 1
    # a full set ends the walk at its last box; a short one at the end
    last = got[-1] if len(got) == k else n - 1
    for i in range(last + 1):
        if i in kept_set or not valid_c[i]:
            continue
        earlier = [g for g in got if g < i]
        if not earlier or iou[earlier, i].max() <= threshold - NMS_TIE:
            bad += 1
    return bad


def rpn_target_violations(cfg: RefConfig, gt_box_norm: torch.Tensor,
                          rpn_match: torch.Tensor) -> int:
    """Anchors whose RPN match breaks the published rule (model.py:
    1090-1181), on float64 IoUs of the reference's anchors with the GT box
    (the batch's normalized box in whole voxels, as the extended box is
    floored and ceiled): a positive below IoU 0.7 that is not among the
    best anchors (the largest IoU, ties kept), a negative at IoU 0.3 or
    more, no positive at all, each positive past half the anchors an
    image, and each negative more or fewer than the rest of the quota (or
    all there are: the anchors below IoU 0.3, less the best one where it
    lies below 0.3)."""
    anc = torch.from_numpy(anchors(cfg)).double()
    gt = torch.round(gt_box_norm.double().cpu()
                     * _shape6(cfg.image_shape, "cpu").double())
    lo = torch.maximum(anc[:, :3], gt[:3])
    hi = torch.minimum(anc[:, 3:], gt[3:])
    edge = torch.clamp(hi - lo, min=0.0)
    inter = edge[:, 0] * edge[:, 1] * edge[:, 2]
    size = anc[:, 3:] - anc[:, :3]
    vol_a = size[:, 0] * size[:, 1] * size[:, 2]
    g = gt[3:] - gt[:3]
    iou = (inter / (vol_a + g[0] * g[1] * g[2] - inter + 1e-6)).numpy()
    match = rpn_match.cpu().numpy().astype(np.int64)
    top = float(iou.max())
    best = iou >= top - 1e-9
    quota = cfg.rpn_train_anchors_per_image
    pos, neg = match == 1, match == -1
    n_pos, n_neg = int(pos.sum()), int(neg.sum())
    bad = int(np.sum(pos & (iou < 0.7) & ~best))
    bad += int(np.sum(neg & (iou >= 0.3)))
    bad += int(n_pos == 0) + max(0, n_pos - quota // 2)
    avail = int(np.sum(iou < 0.3)) - int(top < 0.3)
    return bad + abs(n_neg - min(avail, quota - n_pos))


class Targets(NamedTuple):
    rois: torch.Tensor       # [R, 6] normalized: positives, then negatives
    roi_valid: torch.Tensor  # [R] bool
    class_ids: torch.Tensor  # [R] int64: 1 a positive, 0 else
    deltas: torch.Tensor     # [R, 6] the positives' refinement / bbox_std
    pos_rois: torch.Tensor   # [P, 6]
    pos_valid: torch.Tensor  # [P] bool
    taken: torch.Tensor      # [R] int64: the proposal each slot took, -1


def _pick(uniform, candidate, k):
    """Up to ``k`` candidates, the largest uniforms first, ties to the
    lower index: their positions, padded with -1."""
    ids = torch.nonzero(candidate).flatten().cpu().tolist()
    u = uniform.cpu().tolist()
    ids.sort(key=lambda i: (-u[i], i))
    ids = ids[:k]
    return ids + [-1] * (k - len(ids))


def sample_targets(cfg: RefConfig, proposals, valid, gt_box_norm, u_pos,
                   u_neg) -> Targets:
    """The detection-target sampler on normalized ``proposals`` [N, 6]
    (with ``valid``) against the one GT box, driven by the uniforms the
    program drew (module docstring)."""
    device = proposals.device
    r_cap = cfg.train_rois_per_image
    p_cap = positive_capacity(cfg)
    n_cap = r_cap - p_cap
    iou = iou_matrix(proposals.float(), gt_box_norm.float()[None])[:, 0]
    pos = _pick(u_pos, valid & (iou >= cfg.detection_target_iou), p_cap)
    n_pos = sum(i >= 0 for i in pos)
    quota = 0
    if n_pos:
        ratio = np.float32(cfg.roi_positive_ratio)
        quota = int(np.float32(n_pos) / ratio) - n_pos
    neg = _pick(u_neg, valid & (iou < cfg.detection_target_iou), n_cap)
    neg = [i if j < quota else -1 for j, i in enumerate(neg)]
    taken = torch.tensor(pos + neg, dtype=torch.int64, device=device)
    ok = taken >= 0
    rois = torch.where(ok[:, None], proposals[taken.clamp(min=0)],
                       torch.zeros((), device=device))
    class_ids = torch.zeros(r_cap, dtype=torch.int64, device=device)
    class_ids[:p_cap] = ok[:p_cap].long()
    gt = gt_box_norm.float()[None]
    size = torch.clamp(rois[:, 3:] - rois[:, :3], min=BBOX_EDGE)
    center = rois[:, :3] + 0.5 * (rois[:, 3:] - rois[:, :3])
    gt_size = torch.clamp(gt[:, 3:] - gt[:, :3], min=BBOX_EDGE)
    gt_center = gt[:, :3] + 0.5 * (gt[:, 3:] - gt[:, :3])
    deltas = torch.cat([(gt_center - center) / size,
                        torch.log(gt_size / size)], 1)
    deltas = deltas / torch.tensor(cfg.bbox_std, device=device)
    deltas = torch.where((class_ids > 0)[:, None], deltas,
                         torch.zeros((), device=device))
    return Targets(rois, ok, class_ids, deltas, rois[:p_cap], ok[:p_cap],
                   taken)


def mask_targets(cfg: RefConfig, labels, pos_rois, pos_valid):
    """The positives' GT masks (model.py:481-493): each box in voxels,
    truncated to integers, the label volume cropped to it and resized to
    the mask shape by nearest sampling on the half-pixel map (skimage's
    order 0: ``lo + (i + 0.5) * L / m - 0.5``, clamped into the crop,
    rounded half up), one-hot over the classes: [P, C, m...] float32,
    zero for an empty slot."""
    d, h, w = labels.shape
    boxes = torch.trunc(pos_rois.float() * _shape6((d, h, w),
                                                   labels.device))
    out_shape = tuple(cfg.mask_shape)
    crops = []
    for b in boxes:
        idx = []
        for a, (size, m) in enumerate(zip((d, h, w), out_shape)):
            lo, hi = b[a], b[a + 3]
            i = torch.arange(m, dtype=torch.float32, device=labels.device)
            c = lo + (i + 0.5) * (hi - lo) / m - 0.5
            c = torch.minimum(torch.maximum(c, lo),
                              torch.maximum(hi - 1, lo))
            idx.append(torch.clamp(torch.floor(c + 0.5).long(), 0,
                                   size - 1))
        crops.append(labels[idx[0][:, None, None], idx[1][None, :, None],
                            idx[2][None, None, :]])
    crop = torch.stack(crops)
    onehot = F.one_hot(crop, cfg.num_classes).permute(0, 4, 1, 2, 3)
    return onehot.float() * pos_valid.float()[:, None, None, None, None]


# ---- the mask branch --------------------------------------------------------

def dropout(x, keep, rate):
    """Dropout3d with the given keep mask [N, C, 1, 1, 1]: a dropped
    channel is zero, a kept one scaled by 1 / (1 - rate)."""
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), device=x.device))


def unet(p, x, stage, prec, keep: Optional[List[torch.Tensor]], rate):
    """The Modified 3D U-Net (mask_branch.py) with its training dropout at
    the five sites: after level 1's second conv and between each deeper
    level's two convs (``keep`` None: none).  Its quirks are kept: each
    level's ``c{N}_conv`` applied twice, ``context_1`` before the norm,
    no biases."""
    sites = iter(keep or ())

    def drop(v):
        k = next(sites, None)
        return v if k is None or rate == 0.0 else dropout(v, k, rate)

    def conv(q, v, stride=1):
        return conv3d(q, v, prec, stride)

    def norm_lrelu(v):
        return lrelu(instance_norm(v))

    def up_block(q, v):
        return norm_lrelu(conv(q, up2(norm_lrelu(v))))

    out = conv(p["c1_1"], x)
    residual = out
    out = drop(conv(p["c1_2"], lrelu(out)))
    out = conv(p["c1_lrelu_conv"], lrelu(out)) + residual
    context_1 = lrelu(out)
    out = norm_lrelu(out)
    contexts = []
    for lvl in (2, 3, 4, 5):
        out = conv(p[f"c{lvl}_down"], out, 2)
        residual = out
        out = drop(conv(p[f"c{lvl}_conv"], norm_lrelu(out)))
        out = conv(p[f"c{lvl}_conv"], norm_lrelu(out)) + residual
        if lvl < 5:
            out = norm_lrelu(out)
            contexts.append(out)
    context_2, context_3, context_4 = contexts
    out = up_block(p["l0_up_conv"], out)
    out = norm_lrelu(conv(p["l0_conv"], out))
    out = norm_lrelu(conv(p["l1_conv"], torch.cat([out, context_4], 1)))
    out = up_block(p["l1_up_conv"], conv(p["l1_reduce"], out))
    out = norm_lrelu(conv(p["l2_conv"], torch.cat([out, context_3], 1)))
    ds2 = out
    out = up_block(p["l2_up_conv"], conv(p["l2_reduce"], out))
    out = norm_lrelu(conv(p["l3_conv"], torch.cat([out, context_2], 1)))
    ds3 = out
    out = up_block(p["l3_up_conv"], conv(p["l3_reduce"], out))
    out = norm_lrelu(conv(p["l4_conv"], torch.cat([out, context_1], 1)))
    out = conv(p["l4_out"], out)
    out = out + up2(up2(conv(p["ds2"], ds2)) + conv(p["ds3"], ds3))
    if stage == "finetune":
        up = up2(out)
        out = up + conv(p["out_upscale"], up)
    return out


# ---- the six losses ---------------------------------------------------------

def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _mean_over(values, mask):
    mask = mask.float()
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def rpn_class_loss(rpn_match, logits):
    """Cross entropy over the anchors that are not neutral."""
    ce = F.cross_entropy(logits, (rpn_match == 1).long(), reduction="none")
    return _mean_over(ce, rpn_match != 0)


def rpn_bbox_loss(rpn_match, target, pred):
    """Smooth L1 over the positive anchors' six deltas."""
    return _mean_over(_smooth_l1(pred - target),
                      (rpn_match == 1)[:, None].expand(-1, 6))


def mrcnn_class_loss(t: Targets, logits):
    ce = F.cross_entropy(logits, (t.class_ids > 0).long(), reduction="none")
    return _mean_over(ce, t.roi_valid)


def mrcnn_bbox_loss(t: Targets, pred):
    """Smooth L1 of the positives' foreground deltas."""
    sel = (t.roi_valid & (t.class_ids > 0))[:, None].expand(-1, 6)
    return _mean_over(_smooth_l1(pred[:, 1] - t.deltas), sel)


def mask_loss(target, pos_valid, logits):
    """Voxelwise cross entropy of the one-hot target, over the valid
    positives' voxels."""
    ce = torch.logsumexp(logits, 1) - (logits * target).sum(1)
    return _mean_over(ce, pos_valid[:, None, None, None].expand(ce.shape))


def _sobel():
    kx = torch.tensor([[[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
                       [[2, 4, 2], [0, 0, 0], [-2, -4, -2]],
                       [[1, 2, 1], [0, 0, 0], [-1, -2, -1]]],
                      dtype=torch.float32)
    return torch.stack([kx, kx.permute(1, 0, 2), kx.permute(0, 2, 1)])[:, None]


def mask_edge_loss(target, pos_valid, probs):
    """Mean squared difference of the 3D Sobel gradient magnitudes of the
    foreground classes' target and probabilities, summed over the classes,
    averaged over the valid positives (model.py:938-981)."""
    w = _sobel().to(probs.device)
    per = []
    for t, q in zip(target, probs):
        gt = F.conv3d(t[1:, None], w)
        gq = F.conv3d(q[1:, None], w)
        mt = torch.sqrt((gt ** 2).sum(1) + 1e-12)
        mq = torch.sqrt((gq ** 2).sum(1) + 1e-12)
        per.append(((mq - mt) ** 2).mean(dim=(1, 2, 3)).sum())
    return _mean_over(torch.stack(per), pos_valid)


LOSS_NAMES = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
              "mrcnn_bbox_loss", "mrcnn_mask_loss", "mrcnn_mask_edge_loss")


# ---- the step ---------------------------------------------------------------

class Batch(NamedTuple):
    """What a step takes, as the program took it."""
    image: torch.Tensor        # [1, 1, D, H, W], any float dtype
    rpn_match: torch.Tensor    # [A] in {-1, 0, 1}
    rpn_deltas: torch.Tensor   # [A, 6]
    gt_box_norm: torch.Tensor  # [6]
    labels: torch.Tensor       # [D, H, W] (or its 4-bit packing)
    proposals: torch.Tensor    # [N, 6] normalized, zero past the kept
    proposal_valid: torch.Tensor  # [N] bool
    u_pos: torch.Tensor        # the sampler's uniforms over the proposals
    u_neg: torch.Tensor
    keep: Optional[List[torch.Tensor]]  # the dropout sites' keep masks


def pre_nms_boxes(cfg: RefConfig, logits, deltas) -> torch.Tensor:
    """The proposal layer's boxes before its NMS (model.py:199-258), from
    one image's RPN ``logits`` [A, 2] and ``deltas`` [A, 6]: the
    ``pre_nms_limit`` anchors of the highest foreground scores, refined
    by their deltas times ``rpn_bbox_std`` and clipped to the molded
    volume, in voxels, by score."""
    logits, deltas = logits.detach(), deltas.detach()
    anc = torch.from_numpy(anchors(cfg)).to(logits.device)
    scores = torch.softmax(logits, -1)[:, 1]
    deltas = deltas * torch.tensor(cfg.rpn_bbox_std, device=deltas.device)
    _, order = _top(scores, min(cfg.pre_nms_limit, anc.shape[0]))
    d, h, w = cfg.image_shape
    return clip(apply_deltas(anc[order], deltas[order]),
                torch.tensor([0, 0, 0, d, h, w], dtype=torch.float32,
                             device=anc.device))


def forward(params, cfg: RefConfig, b: Batch, prec="float32"):
    """The forward and the six losses at the program's choices: (total,
    {loss: value}, the sampled targets, the reference's own boxes before
    the proposal layer's NMS)."""
    image = b.image.float()
    p2, p3, logits, deltas = trunk(params, image, prec)
    boxes = pre_nms_boxes(cfg, logits[0], deltas[0])
    t = sample_targets(cfg, b.proposals, b.proposal_valid, b.gt_box_norm,
                       b.u_pos, b.u_neg)
    parts = {"rpn_class_loss": rpn_class_loss(b.rpn_match, logits[0]),
             "rpn_bbox_loss": rpn_bbox_loss(b.rpn_match,
                                            b.rpn_deltas.float(),
                                            deltas[0])}
    pooled = pyramid_pool(cfg, p2, p3, t.rois)
    cls_logits, box_deltas = classifier(params["classifier"], pooled, prec)
    parts["mrcnn_class_loss"] = mrcnn_class_loss(t, cls_logits)
    parts["mrcnn_bbox_loss"] = mrcnn_bbox_loss(t, box_deltas)
    labels = unpack_labels(b.labels, cfg.image_shape[2])
    target = mask_targets(cfg, labels, t.pos_rois, t.pos_valid)
    crops = roi_align(image[0], t.pos_rois, tuple(cfg.mask_pool_size))
    mask_logits = unet(params["mask"]["unet"], crops, cfg.stage, prec,
                       b.keep, cfg.unet_dropout_rate)
    parts["mrcnn_mask_loss"] = mask_loss(target, t.pos_valid, mask_logits)
    if cfg.stage == "finetune":
        parts["mrcnn_mask_edge_loss"] = mask_edge_loss(
            target, t.pos_valid, torch.softmax(mask_logits, 1))
    else:
        parts["mrcnn_mask_edge_loss"] = torch.zeros((), device=image.device)
    weights = dict(cfg.loss_weights)
    total = sum(weights[k] * parts[k] for k in LOSS_NAMES)
    return total, parts, t, boxes


def trainable(path: str) -> bool:
    """Every parameter but the frozen BN statistics trains at heart
    'beginning' and 'finetune'."""
    return not path.endswith(("/mean", "/var"))


def decays(path: str) -> bool:
    """Weight decay on every parameter whose name holds no 'bn'
    (model.py:1538-1541)."""
    return "bn" not in path


def flat(tree, prefix=""):
    """Leaves of a nested dict / list tree by '/'-joined path."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat(v, path + "/"))
        else:
            out[path] = v
    return out


def gradients(params, cfg: RefConfig, b: Batch, prec="float32"):
    """(total, parts, targets, {path: gradient}, pre-NMS boxes): the
    gradients of the trainable leaves of ``params`` (float32, by
    autograd), the rest as ``forward`` gives them."""
    leaves = {p: v for p, v in flat(params).items() if trainable(p)}
    for v in leaves.values():
        v.requires_grad_(True)
    total, parts, t, boxes = forward(params, cfg, b, prec)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    out = {p: torch.zeros_like(v) if g is None else g
           for (p, v), g in zip(leaves.items(), grads)}
    for v in leaves.values():
        v.requires_grad_(False)
    return (total.detach(), {k: v.detach() for k, v in parts.items()}, t,
            out, boxes)


def sgd_update(cfg: RefConfig, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               momentum: Dict[str, Optional[torch.Tensor]]):
    """One optimizer step on leaves by path: (new parameters, new momentum
    buffers), for the leaves of ``grads``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    clip = bool(norm >= cfg.gradient_clip_norm)
    new_p, new_m = {}, {}
    for path, g in grads.items():
        p = params[path]
        if clip:
            g = g / norm * cfg.gradient_clip_norm
        if decays(path):
            g = g + cfg.weight_decay * p
        buf = momentum.get(path)
        buf = g if buf is None else cfg.momentum * buf + g
        new_m[path] = buf
        new_p[path] = p - cfg.learning_rate * buf
    return new_p, new_m
