"""Checkpoint loading of the port: the read side of
``cfun_tpu/utils/checkpoint.py``.

A native checkpoint is the JAX package's ``.npz``: '/'-joined tree paths
under ``params/`` in the JAX layouts (float leaves possibly stored as
float16), optimizer leaves under ``opt/`` and a JSON ``__meta__`` record.
Its leaves are converted to the port's layouts with ``weights._convert``
against a port template tree (``weights.init_params``).  ``load_any`` also
takes a reference PyTorch checkpoint (``torch.save`` of a ``state_dict``),
told apart by content.

Partial (key-filtered) loading supports LiTS-style stage transfer
(LiTS_2017/model.py:1358-1371).  Writing checkpoints, and the optimizer
leaves, belong to training and are not ported yet.
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch

from cfun_tpu_torch import weights
from cfun_tpu_torch.utils import torch_convert


def _is_native_npz(path: str) -> bool:
    """npz archives contain .npy members; torch zip checkpoints contain
    data.pkl + raw storages, and torch legacy checkpoints are bare
    pickles (not zips at all)."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith(".npy") for n in z.namelist())
    except (zipfile.BadZipFile, IsADirectoryError, FileNotFoundError,
            OSError):
        return False


def load_reference_torch(path: str, cfg) -> dict:
    """Import a reference PyTorch checkpoint (``torch.save(state_dict)``,
    reference model.py:1563-1570) as a port parameter tree."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # a checkpoint that pickles whole modules: only for files the
        # caller trusts, as torch.load itself warns
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return torch_convert.maskrcnn_from_torch(obj, cfg)


def load_any(path: str, cfg, params_template,
             strict: bool = False) -> Tuple[dict, Dict]:
    """Load a native .npz checkpoint or a reference PyTorch checkpoint,
    auto-detected by content.  Returns (params, meta).  Reference
    checkpoints carry no epoch metadata (the reference never saves it,
    SURVEY s5); their meta names the source."""
    real = path
    if not os.path.exists(real) and os.path.exists(path + ".npz"):
        real = path + ".npz"
    if _is_native_npz(real):
        return load(real, params_template, strict=strict)
    params = load_reference_torch(real, cfg)
    return params, {"source": "torch", "path": real}


def load(path: str, params_template, strict: bool = True
         ) -> Tuple[dict, Dict]:
    """Restore params shaped like the port tree ``params_template``.
    Returns (params, meta).

    strict=True raises on a template leaf missing from the file or stored
    with another shape.  strict=False key-filters like the LiTS loader:
    such leaves keep their template values, and stored keys the template
    lacks are ignored.  Stored leaves become float32 CPU tensors in the
    port's layouts.
    """
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode()) \
            if "__meta__" in data else {}
        stored = {k[len("params/"):]: k for k in data.files
                  if k.startswith("params/")}
        flat = {}
        for key, leaf in weights._leaves(params_template).items():
            if key not in stored:
                if strict:
                    raise KeyError(f"missing checkpoint key: {key}")
                flat[key] = leaf
                continue
            raw = data[stored[key]]
            arr = (weights._convert(key, raw) if raw.ndim == leaf.dim()
                   else raw)
            if tuple(arr.shape) != tuple(leaf.shape):
                if strict:
                    raise ValueError(
                        f"shape mismatch for {key}: {tuple(raw.shape)} "
                        f"stored, {tuple(leaf.shape)} in the port's layout")
                arr = leaf  # keep the template value
            flat[key] = arr
    return weights._unflatten(flat), meta
