"""Parameters of the port: conversion from the JAX package's tree and
loading of its ``.npz`` checkpoints.

The JAX tree (``cfun_tpu/models/cfun.py::init_params``) is nested dicts and
lists; the port keeps the same nesting and names with PyTorch layouts:

* conv ``w`` ``[kd, kh, kw, C_in, C_out]`` -> ``[C_out, C_in, kd, kh, kw]``;
* linear ``w`` ``[in, out]`` -> ``[out, in]``;
* biases and frozen-BN ``scale``/``bias``/``mean``/``var`` as they are.

The phase-decomposed up-convs and upscale head (``nn.upsample2_conv``,
``nn.upsample2_conv_residual``) build their kernels from the same
``[C_out, C_in, k, k, k]`` leaves at each call, so one tree serves both
forms.

Every leaf is stored as float32 (the checkpoints may hold float16).  The
leaves are checked against ``layout(cfg)``: a leaf the port does not use,
a parameter the tree does not hold and a shape that differs all raise.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from cfun_tpu_torch.models.p3d import BACKBONE_DEPTHS

_BN = ("scale", "bias", "mean", "var")
_UNET = ("c1_1", "c1_2", "c1_lrelu_conv", "c2_down", "c2_conv", "c3_down",
         "c3_conv", "c4_down", "c4_conv", "c5_down", "c5_conv",
         "l0_up_conv", "l0_conv", "l1_conv", "l1_reduce", "l1_up_conv",
         "l2_conv", "l2_reduce", "l2_up_conv", "l3_conv", "l3_reduce",
         "l3_up_conv", "l4_conv", "l4_out", "ds2", "ds3", "out_upscale")


def _leaves(tree, prefix: str = "") -> Dict[str, object]:
    """Leaves of a nested dict / list tree (arrays or tensors, as they
    are) by '/'-joined tree path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _flatten(tree) -> Dict[str, np.ndarray]:
    """:func:`_leaves` as numpy arrays."""
    return {k: np.asarray(v) for k, v in _leaves(tree).items()}


def _unflatten(flat: Dict[str, object]):
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def layout(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter the port's graph reads for ``cfg``: tree path ->
    shape in the port's layout.  The one description of the tree, as the
    JAX package's ``cfun.init_params`` builds it."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(path, k, ci, co, bias=True):
        k = (k, k, k) if isinstance(k, int) else tuple(k)
        shapes[f"{path}/w"] = (co, ci, *k)
        if bias:
            shapes[f"{path}/b"] = (co,)

    def linear(path, ci, co):
        shapes[f"{path}/w"] = (co, ci)
        shapes[f"{path}/b"] = (co,)

    def bn(path, c):
        shapes.update({f"{path}/{n}": (c,) for n in _BN})

    ch0, ch1 = cfg.backbone_channels
    conv("backbone/stem_conv", cfg.backbone_stem_kernel, cfg.image_channels,
         ch0)
    bn("backbone/stem_bn", ch0)
    c_in = ch0
    depths = BACKBONE_DEPTHS[cfg.backbone]
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
    linear("classifier/cls", fc, 2)
    linear("classifier/bbox", fc, 12)
    base, nc = cfg.unet_base_channels, cfg.num_classes
    u3 = {"c1_1": (cfg.image_channels, base), "c1_2": (base, base),
          "c1_lrelu_conv": (base, base)}
    for lvl in (2, 3, 4, 5):
        c = base * 2 ** (lvl - 2)
        u3[f"c{lvl}_down"] = (c, 2 * c)
        u3[f"c{lvl}_conv"] = (2 * c, 2 * c)
    u3.update({"l0_up_conv": (base * 16, base * 8),
               "l1_conv": (base * 16, base * 16),
               "l1_up_conv": (base * 8, base * 4),
               "l2_conv": (base * 8, base * 8),
               "l2_up_conv": (base * 4, base * 2),
               "l3_conv": (base * 4, base * 4),
               "l3_up_conv": (base * 2, base),
               "l4_conv": (base * 2, base * 2)})
    u1 = {"l0_conv": (base * 8, base * 8), "l1_reduce": (base * 16, base * 8),
          "l2_reduce": (base * 8, base * 4), "l3_reduce": (base * 4, base * 2),
          "l4_out": (base * 2, nc), "ds2": (base * 8, nc),
          "ds3": (base * 4, nc)}
    for name in _UNET:
        path = f"mask/unet/{name}"
        if name == "out_upscale":
            conv(path, 5, nc, nc, bias=False)
        elif name in u3:
            conv(path, 3, *u3[name], bias=False)
        else:
            conv(path, 1, *u1[name], bias=False)
    return shapes


def _convert(key: str, arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, np.float32)
    if key.endswith("/w"):
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{key}: weight of rank {arr.ndim}")
    return torch.from_numpy(np.ascontiguousarray(arr))


def init_params(cfg, seed: int = 0) -> dict:
    """Random parameters for ``cfg`` from a seeded ``torch.Generator``,
    with the JAX package's initializers (reference model.py:1306-1319):
    Xavier-uniform conv weights, zero biases, N(0, 0.01) linears, BN
    scale 1 / bias 0 / mean 0 / var 1.  float32 CPU tensors."""
    gen = torch.Generator().manual_seed(seed)
    flat = {}
    for key, shape in layout(cfg).items():
        if key.endswith("/w") and len(shape) == 5:
            field = shape[2] * shape[3] * shape[4]
            limit = (6.0 / (field * (shape[0] + shape[1]))) ** 0.5
            flat[key] = (torch.rand(shape, generator=gen) * 2 - 1) * limit
        elif key.endswith("/w"):
            flat[key] = 0.01 * torch.randn(shape, generator=gen)
        elif key.endswith(("/scale", "/var")):
            flat[key] = torch.ones(shape)
        else:
            flat[key] = torch.zeros(shape)
    return _unflatten(flat)


def params_from_numpy(tree, cfg) -> dict:
    """The JAX package's parameter tree (numpy leaves) -> the port's
    (float32 CPU tensors, PyTorch layouts).  Raises on a leaf the port
    does not use, on a parameter the tree lacks and on a shape that is
    not ``cfg``'s."""
    return checked_tree({k: _convert(k, v)
                         for k, v in _leaves(tree).items()}, cfg)


def checked_tree(flat: Dict[str, torch.Tensor], cfg) -> dict:
    """A port parameter tree from its leaves by tree path, in the port's
    layouts.  Raises on a leaf the port does not use, on a parameter
    missing and on a shape that is not ``cfg``'s."""
    want = layout(cfg)
    missing = sorted(set(want) - set(flat))
    unused = sorted(set(flat) - set(want))
    if missing or unused:
        raise ValueError(f"parameter tree does not match the port's graph: "
                         f"missing {missing[:8]} ({len(missing)}), "
                         f"unused {unused[:8]} ({len(unused)})")
    wrong = [f"{k} {tuple(v.shape)} != {want[k]}" for k, v in flat.items()
             if tuple(v.shape) != want[k]]
    if wrong:
        raise ValueError(f"parameter shapes do not match the config: "
                         f"{wrong[:8]} ({len(wrong)})")
    return _unflatten({k: flat[k] for k in want})


def load_npz(path: str, cfg) -> Tuple[dict, dict]:
    """Read a JAX-package checkpoint (``params/<tree path>`` keys and a JSON
    ``__meta__`` record) with plain ``np.load``.  Returns (port params,
    meta).  Optimizer leaves (``opt/...``) are skipped; every ``params/``
    leaf must be one of ``cfg``'s parameters, with its shape."""
    tree = {}
    meta = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(bytes(z[key]).decode())
            elif key.startswith("params/"):
                tree[key[len("params/"):]] = z[key]
    return params_from_numpy(_unflatten(tree), cfg), meta


def to_device(params, device) -> dict:
    """A copy of a port parameter tree on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)
