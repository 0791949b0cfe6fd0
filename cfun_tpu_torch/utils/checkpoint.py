"""Checkpoints of the port (``cfun_tpu/utils/checkpoint.py``): writing,
in the background too, and reading, in the JAX package's format, so that
each package resumes from the other's.

A native checkpoint is one ``.npz``: '/'-joined tree paths under
``params/`` in the JAX layouts (float32; a stored file may hold float16),
the optimizer's state leaves under ``opt/{i}`` in the order of
``jax.tree_util.tree_leaves`` of the JAX optimizer's state
(``SGDChain.state_leaves``), and a JSON ``__meta__`` record (epoch, step,
name, stage, losses).  Leaves are converted to the port's layouts with
``weights._convert`` against a port template tree.  ``load_any`` also
takes a reference PyTorch checkpoint (``torch.save`` of a
``state_dict``), told apart by content: parameters only, epoch 0.

Partial (key-filtered) loading supports LiTS-style stage transfer
(LiTS_2017/model.py:1358-1371).
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cfun_tpu_torch import weights
from cfun_tpu_torch.utils import torch_convert


def _snapshot(params, opt_state):
    """Host copies of the parameters and the optimizer's state: what the
    caller's next in-place update cannot change."""
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in weights._leaves(params).items()}
    return host, None if opt_state is None else opt_state.host_state()


def _arrays(host, opt_host, epoch: int, step: int, meta: Optional[Dict]
            ) -> Dict[str, np.ndarray]:
    """The ``.npz`` members of a checkpoint from a :func:`_snapshot`."""
    arrays = {f"params/{k}": weights._to_jax_layout(k, v)
              for k, v in host.items()}
    if opt_host is not None:
        for i, leaf in enumerate(opt_host.state_leaves()):
            arrays[f"opt/{i}"] = leaf
    info = {"epoch": int(epoch), "step": int(step)}
    info.update(meta or {})
    arrays["__meta__"] = np.frombuffer(json.dumps(info).encode(),
                                       dtype=np.uint8)
    return arrays


def _write(path: str, arrays: Dict[str, np.ndarray]) -> str:
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return path


def save(path: str, params, epoch: int = 0, step: int = 0,
         opt_state=None, meta: Optional[Dict] = None) -> str:
    """Write ``params`` (a port tree) and, when given, the optimizer's
    state (an ``SGDChain``) to ``path`` (``.npz`` added if missing), with
    the epoch, the step counter and ``meta``.  Returns the file's path."""
    return _write(path, _arrays(*_snapshot(params, opt_state), epoch, step,
                                meta))


_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: List = []


def save_async(path: str, params, epoch: int = 0, step: int = 0,
               opt_state=None, meta: Optional[Dict] = None) -> None:
    """:func:`save` with only the device-to-host copy on the caller's
    thread; the layouts and the ``.npz`` are done by one background writer
    thread (so writes to a path stay ordered).  :func:`flush` before
    reading the file back or exiting."""
    global _WRITER
    # copy now: the caller's next step updates the leaves in place
    host, opt_host = _snapshot(params, opt_state)
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1)
    _PENDING.append(_WRITER.submit(
        lambda: _write(path, _arrays(host, opt_host, epoch, step, meta))))


def flush(raise_errors: bool = True) -> None:
    """Wait for every background write.  All are drained even if one
    failed; the first writer error is raised afterwards, or only printed
    with ``raise_errors=False`` (from a ``finally``, where raising would
    hide the loop's own exception)."""
    first = None
    while _PENDING:
        try:
            _PENDING.pop(0).result()
        except Exception as e:  # noqa: BLE001 -- surfaced after draining
            if first is None:
                first = e
    if first is not None:
        if raise_errors:
            raise first
        print(f"checkpoint: background write failed: {first!r}", flush=True)


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


def load_any(path: str, cfg, params_template, opt_template=None,
             strict: bool = False) -> Tuple[dict, Any, Dict]:
    """Load a native .npz checkpoint or a reference PyTorch checkpoint,
    auto-detected by content.  Returns (params, optimizer, meta); see
    :func:`load`.  Reference checkpoints carry no optimizer state and no
    epoch (the reference never saves them, SURVEY s5): the optimizer
    comes back as given, and the meta names the source."""
    real = path
    if not os.path.exists(real) and os.path.exists(path + ".npz"):
        real = path + ".npz"
    if _is_native_npz(real):
        return load(real, params_template, opt_template, strict=strict)
    params = load_reference_torch(real, cfg)
    return params, opt_template, {"source": "torch", "path": real}


def load(path: str, params_template, opt_template=None, strict: bool = True
         ) -> Tuple[dict, Any, Dict]:
    """Restore params shaped like the port tree ``params_template``, and
    the optimizer state into ``opt_template`` (an ``SGDChain``, whose
    ``load_state_leaves`` takes the ``opt/{i}`` leaves; a slot whose leaf
    count is not the optimizer's leaves it as it is, as the JAX package
    does).  Returns (params, optimizer or None, meta).

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
        opt_keys = sorted((k for k in data.files if k.startswith("opt/")),
                          key=lambda k: int(k.split("/")[1]))
        if opt_template is not None and opt_keys:
            opt_template.load_state_leaves([data[k] for k in opt_keys])
    return weights._unflatten(flat), opt_template, meta
