"""Seeded raw CT-like volumes, made on the device in bulk.

Copies of the formulas of the repository's synthetic data (the heart's
nested ellipsoidal 'organs' over N(0, 1) noise, +3 inside the heart; a
LiTS liver ellipsoid at -150 HU with a tumour core at -280 HU over ~300 HU
background noise, sd 40), sized by the caller and drawn with a
``torch.Generator`` on the device: a 512 x 512 x 363 volume is made in
milliseconds on the card, where NumPy takes seconds.  The same seed on
the same device and PyTorch build gives the same volumes.

A volume ``i`` of a pool draws its organ's centre from
``default_rng((seed, i))`` and its noise from a generator seeded from
the same stream; the sizes are the caller's, fixed, so every seed
serves the same work.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _stream(seed: int, i: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(i)))


def _grid(shape, device):
    h, w, d = shape
    return (torch.arange(h, device=device, dtype=torch.float32)[:, None, None],
            torch.arange(w, device=device, dtype=torch.float32)[None, :, None],
            torch.arange(d, device=device, dtype=torch.float32)[None, None, :])


def heart(shape: Tuple[int, int, int], seed: int, i: int, device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image float32, labels int8), both [H, W, D] on ``device``: seven
    nested ellipsoids (class 1 the largest), N(0, 1) noise, +3 inside."""
    h, w, d = shape
    rng = _stream(seed, i)
    cy, cx = rng.integers(h // 3, 2 * h // 3), rng.integers(w // 3,
                                                            2 * w // 3)
    cz = d // 2
    yy, xx, zz = _grid(shape, device)
    labels = torch.zeros(shape, dtype=torch.int8, device=device)
    for cls in range(1, 8):
        frac = 1.0 - (cls - 1) / 7 * 0.8
        r, rz = max(2.0, (h // 4) * frac), max(1.0, (d // 4) * frac)
        ball = (((yy - cy) / r) ** 2 + ((xx - cx) / r) ** 2
                + ((zz - cz) / rz) ** 2) < 1.0
        labels.masked_fill_(ball, cls)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    image = torch.randn(shape, generator=gen, device=device)
    image += 3.0 * (labels > 0)
    return image, labels


def lits(shape: Tuple[int, int, int], seed: int, i: int, device
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(HU volume float32, labels int8: 1 liver, 2 tumour), both [H, W, D]
    on ``device``."""
    h, w, d = shape
    rng = _stream(seed, i)
    cy, cx = rng.integers(h // 3, 2 * h // 3), rng.integers(w // 3,
                                                            2 * w // 3)
    cz = d // 2
    yy, xx, zz = _grid(shape, device)
    liver = (((yy - cy) / (h // 5)) ** 2 + ((xx - cx) / (w // 5)) ** 2
             + ((zz - cz) / (d // 4)) ** 2) < 1.0
    tumour = (((yy - cy) / (h // 12)) ** 2 + ((xx - cx) / (w // 12)) ** 2
              + ((zz - cz) / (d // 10)) ** 2) < 1.0
    labels = torch.zeros(shape, dtype=torch.int8, device=device)
    labels.masked_fill_(liver, 1)
    labels.masked_fill_(tumour, 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    vol = 300.0 + 40.0 * torch.randn(shape, generator=gen, device=device)
    vol.masked_fill_(liver, -150.0)
    vol.masked_fill_(tumour, -280.0)
    return vol, labels


GENERATORS = {"heart": heart, "lits": lits}


def pool(kind: str, hw: Sequence[int], depths: Sequence[int], seed: int,
         device) -> List[np.ndarray]:
    """One host volume per depth, [H, W, D] float32 NumPy, made on
    ``device``."""
    return [GENERATORS[kind]((hw[0], hw[1], int(d)), seed, i, device)[0]
            .cpu().numpy() for i, d in enumerate(depths)]


def order(n: int, seed: int) -> List[int]:
    """The seed's order of a pool of ``n`` volumes."""
    return [int(v) for v in _stream(seed, n).permutation(n)]
