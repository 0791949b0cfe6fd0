"""The port's CUDA kernel and device path, on a card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On the GPU machine:
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.  chip_smoke.py
runs the same checks at the served shapes.
"""

import numpy as np
import pytest
import torch

from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.inference import Detector
from cfun_tpu_torch.ops import sorted_nms as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,k,thr", [(1, 1, 0.7), (65, 64, 0.3),
                                     (1000, 64, 0.7), (64, 1, 0.3),
                                     (4096, 4096, 0.5)])
def test_kernel_matches_plain(cuda, n, k, thr):
    rng = np.random.default_rng(n)
    lo = rng.uniform(0, 60, size=(n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 30, size=(n, 3))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2).to(cuda)
    before = k1.launches
    idx, keep = k1.sorted_nms(boxes, valid, thr, k)
    assert k1.launches == before + 1
    ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
    assert torch.equal(idx, ridx) and torch.equal(keep, rkeep)


def test_kernel_rejects_oversize(cuda):
    boxes = torch.zeros((4097, 6), device=cuda)
    with pytest.raises(ValueError, match="N <="):
        k1.sorted_nms(boxes, torch.ones(4097, dtype=torch.bool,
                                        device=cuda), 0.5, 4)


def test_detector_card_matches_cpu(cuda):
    cfg = pconfig.tiny_config(detection_max_instances=1,
                              wire_image_dtype="int8", fast_unmold=True,
                              device_normalize=True)
    params = weights.init_params(cfg, seed=0)
    params["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(80, 64, 40)).astype(np.float32)
    vol[20:60, 16:48, 10:30] += 3.0
    torch.backends.cudnn.allow_tf32 = False
    before = k1.launches
    got = Detector(cfg, params).detect(vol)
    assert k1.launches == before + 2
    want = Detector(cfg, params, device="cpu").detect(vol)
    assert got["rois"].shape == want["rois"].shape
    assert np.abs(got["rois"] - want["rois"]).max(initial=0) <= 1
    assert float((got["mask"] == want["mask"]).mean()) >= 0.99
