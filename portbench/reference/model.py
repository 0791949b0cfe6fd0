"""The plain reference of the served CFUN graph, in PyTorch and float32.

A frozen copy of the graph the served request runs (the P3D trunk, the
FPN, the RPN, the proposal layer, pyramid RoIAlign, the classifier, the
detection layer, the Modified 3D U-Net and the fast unmold of both
families), written as plain ``torch`` operations: every convolution is
``F.conv3d`` in float32 with TF32 off, every up-convolution the explicit
nearest upsample and conv, every NMS a plain greedy loop.  It imports
nothing of the program under test and reads only what the benchmark
hands it: a configuration (``RefConfig``, from the configuration file's
``model`` block), parameters (a nested dict of float32 tensors in the
PyTorch layouts, read by ``reference/weights.py``) and a molded volume.

``prec="fp8"`` computes every convolution and matrix product from
per-tensor-scaled float8 (e4m3) copies of its two operands: the control
of the comparison, one step below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F8_MAX = 448.0  # the largest finite float8 e4m3 value
BACKBONE_DEPTHS = {"P3D19": (2, 3), "P3D35": (4, 5)}
PRECISIONS = ("float32", "fp8")


class RefConfig:
    """The configuration numbers the reference reads, from a dict (the
    ``model`` block of a configuration file)."""

    def __init__(self, fields: Dict):
        self.fields = dict(fields)
        for k, v in fields.items():
            setattr(self, k, tuple(v) if isinstance(v, list) else v)

    @property
    def backbone_feature_shapes(self):
        d, h, w = self.image_shape
        return tuple((-(-d // s), -(-h // s), -(-w // s))
                     for s in self.backbone_strides)


def set_plain_precision() -> None:
    """float32 matrix products and convolutions as float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as the precision computes it: float32 as it is, 'fp8' as a
    per-tensor-scaled float8 e4m3 copy, back in float32."""
    if prec == "float32":
        return x
    if prec != "fp8":
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{prec!r}")
    scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def conv3d(p, x, prec, stride=1):
    w = p["w"]
    pads = tuple((k - 1) // 2 for k in w.shape[2:])
    return F.conv3d(_q(x, prec), _q(w, prec), p.get("b"), stride=stride,
                    padding=pads)


def matmul(a, b, prec):
    return _q(a, prec) @ _q(b, prec)


def linear(p, x, prec):
    return matmul(x, p["w"].t(), prec) + p["b"]


def frozen_bn(p, x, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps)
    scale = p["scale"] * inv
    shift = p["bias"] - p["mean"] * p["scale"] * inv
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + shift.reshape(shape)


def instance_norm(x, eps=1e-5):
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def lrelu(x):
    return F.leaky_relu(x, 0.01)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---- trunk -------------------------------------------------------------------

def _bottleneck(p, x, st, expand, stride, prec):
    out = F.relu(frozen_bn(p["bn1"], conv3d(p["conv1"], x, prec, stride)))

    def s_branch(v):
        return F.relu(frozen_bn(p["bn_s"], conv3d(p["conv_s"], v, prec)))

    def t_branch(v):
        return F.relu(frozen_bn(p["bn_t"], conv3d(p["conv_t"], v, prec)))

    if st == "A":
        out = t_branch(s_branch(out))
    elif st == "B":
        out = t_branch(out) + s_branch(out)
    else:
        s = s_branch(out)
        out = s + t_branch(s)
    out = frozen_bn(p["bn4"], conv3d(p["conv4"], out, prec))
    residual = (frozen_bn(p["down_bn"], conv3d(p["down_conv"], x, prec, 2))
                if expand else x)
    return F.relu(out + residual)


def p3d(params, x, prec):
    out = conv3d(params["stem_conv"], x, prec, stride=2)
    out = F.max_pool3d(F.relu(frozen_bn(params["stem_bn"], out)), 2, 2)
    feats = []
    for stage in (2, 3):
        for b, bp in enumerate(params[f"c{stage}"]):
            out = _bottleneck(bp, out, "ABC"[b % 3], b == 0,
                              2 if b == 0 else 1, prec)
        feats.append(out)
    return feats


def fpn(params, c2, c3, prec):
    p3 = conv3d(params["p3_conv1"], c3, prec)
    p2 = conv3d(params["p2_conv1"], c2, prec) + up2(p3)
    return (conv3d(params["p2_conv2"], p2, prec),
            conv3d(params["p3_conv2"], p3, prec))


def rpn(params, feat, prec):
    x = F.relu(conv3d(params["shared"], feat, prec))
    cls, bbox = conv3d(params["cls"], x, prec), conv3d(params["bbox"], x, prec)

    def flat(y, k):
        return y.permute(0, 2, 3, 4, 1).reshape(y.shape[0], -1, k)

    return flat(cls, 2), flat(bbox, 6)


def trunk(params, image, prec):
    c2, c3 = p3d(params["backbone"], image, prec)
    p2, p3 = fpn(params["fpn"], c2, c3, prec)
    l2, d2 = rpn(params["rpn"], p2, prec)
    l3, d3 = rpn(params["rpn"], p3, prec)
    return p2, p3, torch.cat([l2, l3], 1), torch.cat([d2, d3], 1)


# ---- boxes, anchors, NMS -------------------------------------------------------

def anchors(cfg: RefConfig) -> np.ndarray:
    """Cube anchors, z-major (D, H, W, anchor) per level, centred at
    ``cell * stride``; ratios shape the transverse plane."""
    out = []
    for scale, (fd, fh, fw), stride in zip(cfg.anchor_scales,
                                           cfg.backbone_feature_shapes,
                                           cfg.backbone_strides):
        s = cfg.anchor_stride
        zs, ys, xs = (np.arange(0, n, s, dtype=np.float32) * stride
                      for n in (fd, fh, fw))
        sizes = np.asarray([(scale, scale * np.sqrt(r), scale / np.sqrt(r))
                            for r in cfg.anchor_ratios], np.float32)
        cz, cy, cx = np.meshgrid(zs, ys, xs, indexing="ij")
        centers = np.stack([cz, cy, cx], -1).reshape(-1, 1, 3)
        half = 0.5 * sizes[None]
        out.append(np.concatenate([centers - half, centers + half],
                                  -1).reshape(-1, 6))
    return np.concatenate(out).astype(np.float32)


def iou_matrix(a, b, eps=1e-6):
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    edge = torch.clamp(hi - lo, min=0.0)
    inter = edge[..., 0] * edge[..., 1] * edge[..., 2]

    def vol(x):
        return (x[:, 3] - x[:, 0]) * (x[:, 4] - x[:, 1]) * (x[:, 5] - x[:, 2])

    return inter / ((vol(a)[:, None] + vol(b)[None, :] - inter) + eps)


class NmsCall(NamedTuple):
    """One NMS call's inputs and outputs, as a roofline reads them."""
    valid: torch.Tensor
    idx: torch.Tensor
    keep: torch.Tensor


def greedy_nms(boxes, valid, threshold, k, calls: Optional[List] = None):
    """Greedy NMS over score-sorted boxes: walk them in order, keep a box
    no kept box overlaps by IoU > ``threshold``, stop at ``k``.  Returns
    (idx [k] int64, keep [k] bool), unfilled slots 0 / False."""
    over = (iou_matrix(boxes, boxes) > threshold).cpu().numpy()
    live = valid.cpu().numpy().copy()
    kept = []
    for i in range(boxes.shape[0]):
        if len(kept) == k:
            break
        if live[i]:
            kept.append(i)
            live &= ~over[i]
    idx = torch.zeros(k, dtype=torch.int64)
    idx[:len(kept)] = torch.tensor(kept, dtype=torch.int64)
    keep = torch.arange(k) < len(kept)
    idx, keep = idx.to(boxes.device), keep.to(boxes.device)
    if calls is not None:
        calls.append(NmsCall(valid.detach().cpu(), idx.cpu(), keep.cpu()))
    return idx, keep


def apply_deltas(boxes, deltas):
    size = boxes[:, 3:] - boxes[:, :3]
    center = boxes[:, :3] + 0.5 * size + deltas[:, :3] * size
    size = size * torch.exp(deltas[:, 3:])
    lo = center - 0.5 * size
    return torch.cat([lo, lo + size], 1)


def clip(boxes, window):
    lo = torch.minimum(torch.maximum(boxes[:, :3], window[:3]), window[3:])
    hi = torch.minimum(torch.maximum(boxes[:, 3:], window[:3]), window[3:])
    return torch.cat([lo, hi], 1)


def _top(scores, k):
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


def _shape6(shape, device):
    d, h, w = shape
    return torch.tensor([d, h, w, d, h, w], dtype=torch.float32,
                        device=device)


# ---- sampling -------------------------------------------------------------------

def _axis_weights(coords, size):
    c = torch.clamp(coords, 0.0, size - 1.0)
    i0 = torch.floor(c).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    f = (c - i0.float())[..., None]
    return (F.one_hot(i0, size).float() * (1.0 - f)
            + F.one_hot(i1, size).float() * f)


def roi_align(vol, boxes, out_shape):
    """RoIAlign of ``vol`` [C, D, H, W] over [K, 6] normalized boxes: the
    box floored / ceiled to the grid and sampled with align-corners ->
    [K, C, *out_shape]."""
    d, h, w = vol.shape[1:]
    b = boxes * _shape6((d, h, w), vol.device)
    lo, hi = torch.floor(b[:, :3]), torch.ceil(b[:, 3:])
    ws = []
    for a, n in enumerate((d, h, w)):
        length = torch.clamp(hi[:, a] - lo[:, a], min=1.0)
        step = (length - 1.0) / max(out_shape[a] - 1, 1)
        grid = torch.arange(out_shape[a], dtype=torch.float32,
                            device=vol.device)
        ws.append(_axis_weights(lo[:, a, None] + grid[None] * step[:, None],
                                n))
    out = torch.einsum("kzD,CDHW->kCzHW", ws[0], vol)
    out = torch.einsum("kyH,kCzHW->kCzyW", ws[1], out)
    return torch.einsum("kxW,kCzyW->kCzyx", ws[2], out)


# ---- heads ----------------------------------------------------------------------

def classifier(params, pooled, prec):
    n = pooled.shape[0]
    w = params["conv1"]["w"]
    x = matmul(pooled.reshape(n, -1), w.reshape(w.shape[0], -1).t(), prec)
    x = (x + params["conv1"]["b"])[:, :, None, None, None]
    x = F.relu(frozen_bn(params["bn1"], x, eps=1e-3))
    x = F.relu(frozen_bn(params["bn2"], conv3d(params["conv2"], x, prec),
                         eps=1e-3))
    x = x.reshape(n, -1)
    return (linear(params["cls"], x, prec),
            linear(params["bbox"], x, prec).reshape(n, 2, 6))


def unet(p, x, stage, prec):
    """The Modified 3D U-Net (explicit up-convolutions, no dropout)."""
    def conv(q, v, stride=1):
        return conv3d(q, v, prec, stride)

    def up_block(q, v):
        return lrelu(instance_norm(conv(q, up2(lrelu(instance_norm(v))))))

    out = conv(p["c1_1"], x)
    residual = out
    out = conv(p["c1_2"], lrelu(out))
    out = conv(p["c1_lrelu_conv"], lrelu(out)) + residual
    context_1 = lrelu(out)
    out = lrelu(instance_norm(out))
    contexts = []
    for lvl in (2, 3, 4, 5):
        out = conv(p[f"c{lvl}_down"], out, 2)
        residual = out
        out = conv(p[f"c{lvl}_conv"], lrelu(instance_norm(out)))
        out = conv(p[f"c{lvl}_conv"], lrelu(instance_norm(out))) + residual
        if lvl < 5:
            out = lrelu(instance_norm(out))
            contexts.append(out)
    context_2, context_3, context_4 = contexts
    out = up_block(p["l0_up_conv"], out)
    out = lrelu(instance_norm(conv(p["l0_conv"], out)))
    out = lrelu(instance_norm(conv(p["l1_conv"],
                                   torch.cat([out, context_4], 1))))
    out = up_block(p["l1_up_conv"], conv(p["l1_reduce"], out))
    out = lrelu(instance_norm(conv(p["l2_conv"],
                                   torch.cat([out, context_3], 1))))
    ds2 = out
    out = up_block(p["l2_up_conv"], conv(p["l2_reduce"], out))
    out = lrelu(instance_norm(conv(p["l3_conv"],
                                   torch.cat([out, context_2], 1))))
    ds3 = out
    out = up_block(p["l3_up_conv"], conv(p["l3_reduce"], out))
    out = lrelu(instance_norm(conv(p["l4_conv"],
                                   torch.cat([out, context_1], 1))))
    out = conv(p["l4_out"], out)
    out = out + up2(up2(conv(p["ds2"], ds2)) + conv(p["ds3"], ds3))
    if stage == "finetune":
        up = up2(out)
        out = up + conv(p["out_upscale"], up)
    return out


# ---- the served graph -------------------------------------------------------------

def propose(cfg, logits, deltas, anc, calls):
    scores = torch.softmax(logits, -1)[:, 1]
    deltas = deltas * torch.tensor(cfg.rpn_bbox_std, device=deltas.device)
    _, order = _top(scores, min(cfg.pre_nms_limit, anc.shape[0]))
    d, h, w = cfg.image_shape
    boxes = clip(apply_deltas(anc[order], deltas[order]),
                 torch.tensor([0, 0, 0, d, h, w], dtype=torch.float32,
                              device=anc.device))
    valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=anc.device)
    idx, keep = greedy_nms(boxes, valid, cfg.rpn_nms_threshold,
                           cfg.post_nms_rois_inference, calls)
    props = torch.where(keep[:, None], boxes[idx], torch.zeros_like(
        boxes[idx]))
    return props / _shape6(cfg.image_shape, anc.device), keep


def refine(cfg, rois, roi_valid, probs, deltas, window, calls):
    """The detection layer: every proposal's box refined by its class's
    deltas (rounded molded voxels, clipped to the window) and scored; the
    candidates (foreground, confident, valid) NMS'd to at most
    ``detection_max_instances``.  Returns (detections [Dmax, 8], kept)."""
    class_ids = torch.argmax(probs, -1)
    scores = probs.gather(1, class_ids[:, None])[:, 0]
    sel = deltas[torch.arange(deltas.shape[0], device=deltas.device),
                 class_ids]
    refined = apply_deltas(rois, sel * torch.tensor(cfg.rpn_bbox_std,
                                                    device=rois.device))
    refined = torch.round(clip(refined * _shape6(cfg.image_shape,
                                                 rois.device), window))
    foreground = roi_valid & (class_ids > 0)
    keep = foreground & (scores >= cfg.detection_min_confidence)
    _, order = _top(scores, scores.shape[0])
    idx_s, kept = greedy_nms(refined[order], keep[order],
                             cfg.detection_nms_threshold,
                             cfg.detection_max_instances, calls)
    idx = order[idx_s]
    zero = torch.zeros((), device=rois.device)
    det = torch.cat([torch.where(kept[:, None], refined[idx],
                                 torch.zeros_like(refined[idx])),
                     torch.where(kept, class_ids[idx].float(), zero)[:, None],
                     torch.where(kept, scores[idx], zero)[:, None]], 1)
    return det, kept


def _paste_weights(lo, hi, m, n):
    i = torch.arange(n, dtype=torch.float32, device=lo.device)[None]
    lo, hi = lo[:, None], hi[:, None]
    inv = 1.0 / (torch.clamp(hi - lo, min=1.0) / m)
    src = (i + 0.5) * inv - lo * inv - 0.5
    inside = ((i >= lo) & (i < hi)).float()
    keep = inside * ((src >= -0.5) & (src <= m - 0.5)).float()
    src = torch.clamp(src, 0.0, m - 1.0)
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=m - 1)
    w = torch.zeros((*src.shape, m), device=lo.device)
    w.scatter_add_(2, i0[..., None], ((1.0 - frac) * keep)[..., None])
    w.scatter_add_(2, i1[..., None], (frac * keep)[..., None])
    return w, inside


def overlap_paste_probs(cfg, probs, det, valid, prec):
    """Every valid detection's probabilities resized trilinearly
    (half-pixel, edge-renormalised) into its box of the molded volume,
    averaged over the boxes that cover a voxel, clipped to [0, 1]: [C, D,
    H, W], 0 outside every box."""
    d, h, w = cfg.image_shape
    k, c, md, mh, mw = probs.shape
    v = valid.float()
    boxes = det[:, :6]
    wz, in_z = _paste_weights(boxes[:, 0], boxes[:, 3], md, d)
    wy, in_y = _paste_weights(boxes[:, 1], boxes[:, 4], mh, h)
    wx, in_x = _paste_weights(boxes[:, 2], boxes[:, 5], mw, w)
    acc = torch.zeros((c, d, h * w), device=probs.device)
    for i in range(k):
        if not bool(valid[i]):
            continue
        x = matmul(probs[i].reshape(c * md * mh, mw), wx[i].t(), prec)
        y = matmul(wy[i], x.view(c, md, mh, w), prec).view(c, md, h * w)
        acc += matmul(wz[i].expand(c, d, md), y, prec)
    cnt = (in_z * v[:, None]).t() @ (in_y[:, :, None]
                                     * in_x[:, None, :]).view(k, h * w)
    return (acc / (cnt + 1e-6)).clamp(0.0, 1.0).view(c, d, h, w)


def uses_overlap_paste(cfg) -> bool:
    return cfg.name == "lits" or cfg.detection_max_instances > 1


def label_probs(params, cfg: "RefConfig", image, det, kept, prec="float32"):
    """The class probabilities whose argmax the served labels are, for the
    detections ``det`` [Dmax, 8] (molded voxel boxes) / ``kept``: the
    overlap paste's [C, D, H, W] volume (LiTS, several instances), else
    each detection's crop probabilities, upsampled 2x but at 'finetune':
    [Dmax, C, 2m...]."""
    crops = roi_align(image[0], det[:, :6] / _shape6(cfg.image_shape,
                                                     det.device),
                      tuple(cfg.mask_pool_size))
    probs = torch.softmax(unet(params["mask"]["unet"], crops, cfg.stage,
                               prec), 1)
    if uses_overlap_paste(cfg):
        return overlap_paste_probs(cfg, probs, det, kept, prec)
    if cfg.stage != "finetune":
        probs = F.interpolate(probs, scale_factor=2, mode="trilinear",
                              align_corners=False)
    return probs


class Served(NamedTuple):
    detections: torch.Tensor  # [Dmax, 8] molded voxel boxes, class, score
    kept: torch.Tensor        # [Dmax] bool
    labels: torch.Tensor      # int8: [Dmax, 2m...] crops or [D, H, W]
    nms_calls: List[NmsCall]  # the NMS calls in graph order
    features: Tuple           # (p2, p3): the pyramid the classifier reads


def pyramid_pool(cfg, p2, p3, boxes):
    """RoIAlign of [K, 6] normalized boxes from the pyramid level their
    size picks: [K, C, *pool_size]."""
    size = torch.clamp(boxes[:, 3:] - boxes[:, :3], min=1e-9)
    level = torch.clamp(torch.round(4.0 + torch.log2(
        size[:, 0] * size[:, 1] * size[:, 2]) / 3.0), 2, 3)
    return torch.where((level == 2)[:, None, None, None, None],
                       roi_align(p2[0], boxes, tuple(cfg.pool_size)),
                       roi_align(p3[0], boxes, tuple(cfg.pool_size)))


@torch.no_grad()
def rescore(params, cfg: RefConfig, served: Served, boxes,
            prec="float32"):
    """The classifier's class probabilities [K, 2] at [K, 6] molded voxel
    boxes, pooled from the reference's own pyramid."""
    if boxes.shape[0] == 0:
        return torch.zeros((0, 2), device=boxes.device)
    p2, p3 = served.features
    pooled = pyramid_pool(cfg, p2, p3,
                          boxes / _shape6(cfg.image_shape, boxes.device))
    return torch.softmax(classifier(params["classifier"], pooled, prec)[0],
                         -1)


@torch.no_grad()
def serve(params, cfg: RefConfig, image, window, prec="float32") -> Served:
    """The served graph on a molded float32 volume ``image`` [1, 1, D, H,
    W] with the raw volume's ``window`` [6] in it."""
    calls: List[NmsCall] = []
    anc = torch.from_numpy(anchors(cfg)).to(image.device)
    p2, p3, logits, deltas = trunk(params, image, prec)
    rois, valid = propose(cfg, logits[0], deltas[0], anc, calls)
    pooled = pyramid_pool(cfg, p2, p3, rois)
    logits_c, deltas_c = classifier(params["classifier"], pooled, prec)
    del pooled
    det, kept = refine(cfg, rois, valid, torch.softmax(logits_c, -1),
                       deltas_c, window, calls)
    probs = label_probs(params, cfg, image, det, kept, prec)
    dim = 0 if uses_overlap_paste(cfg) else 1
    labels = torch.argmax(probs, dim).to(torch.int8)
    return Served(det, kept, labels, calls, (p2, p3))
