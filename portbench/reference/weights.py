"""Parameters for the plain reference, read from a checkpoint file.

A checkpoint is a NumPy ``.npz`` with ``params/<tree path>`` leaves in
the JAX layouts (conv ``w`` [kd, kh, kw, C_in, C_out], linear ``w``
[in, out]); the reference takes conv ``w`` as [C_out, C_in, kd, kh, kw]
and linear ``w`` as [out, in], every leaf float32, in nested dicts with
lists where the path has numbered items.  Read here from the raw file,
so the reference takes nothing the program has made of it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.model import BACKBONE_DEPTHS


def _convert(key: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if key.endswith("/w"):
        arr = arr.transpose(4, 3, 0, 1, 2) if arr.ndim == 5 else arr.T
    return np.ascontiguousarray(arr)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """Leaves by '/'-joined path -> nested dicts, lists where every key of
    a level is a number."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def load_npz(path: str, device) -> dict:
    """The ``params/`` leaves of a checkpoint as a nested dict of float32
    tensors on ``device``."""
    flat = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key.startswith("params/"):
                name = key[len("params/"):]
                flat[name] = torch.from_numpy(_convert(name, z[key])).to(
                    device)
    return nest(flat)


_BN = ("scale", "bias", "mean", "var")


def layout(cfg) -> Dict[str, tuple]:
    """Every parameter of the graph of ``cfg`` (a ``RefConfig``): tree
    path -> shape in the reference's layouts."""
    shapes: Dict[str, tuple] = {}

    def conv(path, k, ci, co, bias=True):
        k = (k, k, k) if isinstance(k, int) else tuple(k)
        shapes[f"{path}/w"] = (co, ci, *k)
        if bias:
            shapes[f"{path}/b"] = (co,)

    def bn(path, c):
        shapes.update({f"{path}/{n}": (c,) for n in _BN})

    depths = BACKBONE_DEPTHS[cfg.backbone]
    ch0, ch1 = cfg.backbone_channels
    conv("backbone/stem_conv", cfg.backbone_stem_kernel, cfg.image_channels,
         ch0)
    bn("backbone/stem_bn", ch0)
    c_in = ch0
    for stage, (planes, depth) in enumerate(zip((ch0, ch1), depths)):
        for b in range(depth):
            p = f"backbone/c{stage + 2}/{b}"
            c_out = planes * 4 if b == 0 else c_in
            conv(f"{p}/conv1", 1, c_in, planes)
            bn(f"{p}/bn1", planes)
            conv(f"{p}/conv_s", (1, 3, 3), planes, planes)
            bn(f"{p}/bn_s", planes)
            conv(f"{p}/conv_t", (3, 1, 1), planes, planes)
            bn(f"{p}/bn_t", planes)
            conv(f"{p}/conv4", 1, planes, c_out)
            bn(f"{p}/bn4", c_out)
            if b == 0:
                conv(f"{p}/down_conv", 1, c_in, planes * 4)
                bn(f"{p}/down_bn", planes * 4)
            c_in = c_out
    f = cfg.fpn_channels
    conv("fpn/p3_conv1", 1, ch1 * 4, f)
    conv("fpn/p3_conv2", 3, f, f)
    conv("fpn/p2_conv1", 1, ch0 * 4, f)
    conv("fpn/p2_conv2", 3, f, f)
    a, rc = len(cfg.anchor_ratios), cfg.rpn_conv_channels
    conv("rpn/shared", 3, f, rc)
    conv("rpn/cls", 1, rc, 2 * a)
    conv("rpn/bbox", 1, rc, 6 * a)
    fc = cfg.fc_size
    conv("classifier/conv1", tuple(cfg.pool_size), f, fc)
    bn("classifier/bn1", fc)
    conv("classifier/conv2", 1, fc, fc)
    bn("classifier/bn2", fc)
    shapes.update({"classifier/cls/w": (2, fc), "classifier/cls/b": (2,),
                   "classifier/bbox/w": (12, fc),
                   "classifier/bbox/b": (12,)})
    base, nc = cfg.unet_base_channels, cfg.num_classes
    u3 = {"c1_1": (cfg.image_channels, base), "c1_2": (base, base),
          "c1_lrelu_conv": (base, base), "l0_up_conv": (base * 16, base * 8),
          "l1_conv": (base * 16, base * 16),
          "l1_up_conv": (base * 8, base * 4), "l2_conv": (base * 8, base * 8),
          "l2_up_conv": (base * 4, base * 2), "l3_conv": (base * 4, base * 4),
          "l3_up_conv": (base * 2, base), "l4_conv": (base * 2, base * 2)}
    for lvl in (2, 3, 4, 5):
        c = base * 2 ** (lvl - 2)
        u3[f"c{lvl}_down"] = (c, 2 * c)
        u3[f"c{lvl}_conv"] = (2 * c, 2 * c)
    u1 = {"l0_conv": (base * 8, base * 8), "l1_reduce": (base * 16, base * 8),
          "l2_reduce": (base * 8, base * 4), "l3_reduce": (base * 4, base * 2),
          "l4_out": (base * 2, nc), "ds2": (base * 8, nc),
          "ds3": (base * 4, nc)}
    for name, io in u3.items():
        conv(f"mask/unet/{name}", 3, *io, bias=False)
    for name, io in u1.items():
        conv(f"mask/unet/{name}", 1, *io, bias=False)
    conv("mask/unet/out_upscale", 5, nc, nc, bias=False)
    return shapes


def seeded_flat(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random float32 parameters from ``seed``, made on ``device`` in two
    draws: conv weights uniform in +-sqrt(6 / (fan_in + fan_out)) (the
    Xavier bound), linear weights N(0, 0.01), biases 0, frozen BN scale 1
    / shift 0 / mean 0 / var 1.  Leaves by tree path."""
    shapes = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    uniform = torch.rand(sum(sizes.values()), generator=gen, device=device)
    normal = torch.randn(sum(sizes.values()), generator=gen, device=device)
    flat, at = {}, 0
    for key, shape in shapes.items():
        n = sizes[key]
        if key.endswith("/w") and len(shape) == 5:
            fan = shape[2] * shape[3] * shape[4]
            limit = (6.0 / (fan * (shape[0] + shape[1]))) ** 0.5
            leaf = (uniform[at:at + n] * 2 - 1) * limit
        elif key.endswith("/w"):
            leaf = 0.01 * normal[at:at + n]
        elif key.endswith(("/scale", "/var")):
            leaf = torch.ones(n, device=device)
        else:
            leaf = torch.zeros(n, device=device)
        flat[key] = leaf.reshape(shape).clone()
        at += n
    return flat
