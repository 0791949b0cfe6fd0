"""``Detector.detect_stream`` of the port, on the CPU: the three-stage
pipeline (mold of N+1 on the calling thread, device work of N, fetch and
unmold on one worker thread) returns exactly the serial ``detect``
results, in order, for volumes of different shapes, with at most two
volumes in flight; and ``warmup`` sets up what the first request would.
"""

import numpy as np
import pytest
import torch

from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.inference import Detector

SHAPES = [(60, 70, 30), (80, 96, 40), (64, 64, 32)]


@pytest.fixture(scope="module")
def detector():
    cfg = pconfig.tiny_config(detection_max_instances=1,
                              wire_image_dtype="int8", fast_unmold=True,
                              device_normalize=True, wire_slabs=2)
    params = weights.init_params(cfg, seed=0)
    # a confident FG class, so every volume has a detection to compare
    params["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
    det = Detector(cfg, params, device="cpu")
    assert det._pipelined and det._slab_ranges() == [(0, 16), (16, 16)]
    yield det
    det.close()


def _volumes():
    rng = np.random.default_rng(7)
    vols = []
    for i, shape in enumerate(SHAPES):
        v = rng.normal(size=shape).astype(np.float32)
        v[10:40, 10:40, 5:25] += 2.0 + i
        vols.append(v)
    return vols


def test_detect_stream_matches_serial(detector):
    vols = _volumes()
    serial = [detector.detect(v) for v in vols]
    assert all(len(r["scores"]) >= 1 for r in serial)

    pulled = []

    def source():
        for v in vols:
            pulled.append(v.shape)
            yield v

    streamed = []
    for i, result in enumerate(detector.detect_stream(source())):
        # volumes taken from the source but not yet returned
        assert len(pulled) - i <= 2, f"{len(pulled) - i} volumes in flight"
        streamed.append(result)
    assert len(streamed) == len(serial)
    for vol, s, r in zip(vols, streamed, serial):
        assert s["mask"].shape == vol.shape
        np.testing.assert_array_equal(s["mask"], r["mask"])
        np.testing.assert_array_equal(s["rois"], r["rois"])
        np.testing.assert_array_equal(s["class_ids"], r["class_ids"])
        np.testing.assert_allclose(s["scores"], r["scores"], rtol=1e-6)


def test_detect_stream_of_nothing_and_one(detector):
    assert list(detector.detect_stream([])) == []
    vol = _volumes()[0]
    (one,) = detector.detect_stream(iter([vol]))
    np.testing.assert_array_equal(one["mask"], detector.detect(vol)["mask"])
    # close() ends the dispatch thread; the next stream starts another
    detector.close()
    assert detector._dispatch_thread is None
    (again,) = detector.detect_stream([vol])
    np.testing.assert_array_equal(again["mask"], one["mask"])


def test_detect_records_timings_and_wire_bytes(detector):
    vol = _volumes()[1]
    detector.warmup()
    detector.detect(vol)
    assert set(detector.last_timings) == {"mold", "device", "unmold",
                                          "total"}
    assert set(detector.last_sub_timings) == {"fetch", "unpack", "paste"}
    d, h, w = detector.cfg.image_shape
    # 8 f32 and a validity byte for the one detection, then its 2x mask
    # crop of 16^3 labels at 2 bits a label (4 classes)
    assert detector.pack_bits == 2
    assert detector.last_wire_bytes == {"up": d * h * w,
                                        "down": 33 + 32 ** 3 // 4}
