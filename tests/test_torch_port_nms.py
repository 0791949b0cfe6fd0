"""Port NMS (cfun_tpu_torch.ops.sorted_nms / ops.nms) against the JAX
package's Pallas kernel (interpret mode) and scan NMS, on the CPU.

Keep-sets must match exactly: same indices, same order, same mask.  The
CUDA kernel itself runs only on a card (tests/test_torch_port_cuda.py and
chip_smoke.py); here the wrapper takes the plain version because the
tensors lie on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.ops.nms import masked_nms as jax_masked_nms
from cfun_tpu.ops.pallas_nms import pallas_sorted_nms
from cfun_tpu_torch import _build
from cfun_tpu_torch.ops import sorted_nms as port
from cfun_tpu_torch.ops.nms import masked_nms, nms_gather


def _sorted_candidates(seed, n, integer=False):
    """Score-sorted boxes with duplicates, tied scores and (optionally)
    integer corners, as refine_detections produces."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 60, size=(n, 3))
    sz = rng.uniform(3, 30, size=(n, 3))
    boxes = np.concatenate([lo, lo + sz], axis=1).astype(np.float32)
    if integer:
        boxes = np.round(boxes)
    if n > 4:
        boxes[n // 2] = boxes[1]  # a duplicate
    scores = np.round(rng.uniform(size=n), 2).astype(np.float32)  # ties
    order = np.argsort(-scores, kind="stable")
    valid = rng.uniform(size=n) > 0.2
    return boxes[order], scores[order], valid


def _kept(idx, keep):
    return [int(i) for i, k in zip(np.asarray(idx), np.asarray(keep)) if k]


@pytest.mark.parametrize("n,k,thr,integer", [
    (40, 8, 0.3, False),
    (100, 20, 0.4, True),
    (200, 64, 0.7, False),
    (256, 3, 0.7, True),     # k reached early
    (256, 256, 0.3, False),  # k = N
])
def test_reference_matches_pallas_interpret(n, k, thr, integer):
    boxes, _, valid = _sorted_candidates(n, n, integer)
    idx_j, keep_j = pallas_sorted_nms(jnp.asarray(boxes), jnp.asarray(valid),
                                      thr, k, interpret=True)
    idx_t, keep_t = port.sorted_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), thr, k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert idx_t.dtype == torch.int32 and keep_t.dtype == torch.bool


@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_reference_matches_scan_nms_at_main_path_size(thr):
    """N = pre_nms_limit = 1000 -> 64 proposals, against the JAX scan NMS
    (exact kept lists)."""
    boxes, scores, valid = _sorted_candidates(11, 1000)
    idx_j, keep_j = jax_masked_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), thr, 64)
    idx_t, keep_t = port.sorted_nms_reference(torch.from_numpy(boxes),
                                              torch.from_numpy(valid), thr, 64)
    assert _kept(idx_t, keep_t) == _kept(idx_j, keep_j)


def test_port_masked_nms_matches_jax():
    boxes, scores, valid = _sorted_candidates(5, 300)
    perm = np.random.default_rng(0).permutation(300)  # unsorted input
    b, s, v = boxes[perm], scores[perm], valid[perm]
    idx_j, keep_j = jax_masked_nms(jnp.asarray(b), jnp.asarray(s),
                                   jnp.asarray(v), 0.5, 32)
    idx_t, keep_t = masked_nms(torch.from_numpy(b), torch.from_numpy(s),
                               torch.from_numpy(v), 0.5, 32)
    assert _kept(idx_t, keep_t) == _kept(idx_j, keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_validity_and_capacity():
    """tests/test_pallas_nms.py:36-44: an invalid top box is skipped and
    capacity stops the sweep."""
    boxes, _, _ = _sorted_candidates(7, 40)
    valid = np.ones(40, bool)
    valid[0] = False
    idx, keep = port.sorted_nms(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.99, 4)
    assert _kept(idx, keep) == [1, 2, 3, 4]


def test_unfilled_slots_and_empty_input():
    boxes = torch.tensor([[0, 0, 0, 10, 10, 10],
                          [0, 0, 0, 10, 10, 10],
                          [50, 50, 50, 60, 60, 60]], dtype=torch.float32)
    idx, keep = port.sorted_nms(boxes, torch.ones(3, dtype=torch.bool),
                                0.5, 5)
    assert idx.tolist() == [0, 2, 0, 0, 0]
    assert keep.tolist() == [True, True, False, False, False]
    idx, keep = port.sorted_nms(torch.zeros((0, 6)),
                                torch.zeros(0, dtype=torch.bool), 0.5, 2)
    assert idx.tolist() == [0, 0] and keep.tolist() == [False, False]


def test_nms_gather_zeroes_unkept():
    boxes = torch.arange(18, dtype=torch.float32).reshape(3, 6)
    out = nms_gather(boxes, torch.tensor([2, 0], dtype=torch.int32),
                     torch.tensor([True, False]))
    assert out[0].tolist() == boxes[2].tolist()
    assert out[1].tolist() == [0.0] * 6


@pytest.mark.parametrize("boxes,valid,k,err", [
    (torch.zeros((4, 5)), torch.ones(4, dtype=torch.bool), 2, ValueError),
    (torch.zeros((4, 6), dtype=torch.float64),
     torch.ones(4, dtype=torch.bool), 2, TypeError),
    (torch.zeros((4, 6)), torch.ones(3, dtype=torch.bool), 2, ValueError),
    (torch.zeros((4, 6)), torch.ones(4, dtype=torch.bool), 0, ValueError),
])
def test_wrapper_rejects_bad_inputs(boxes, valid, k, err):
    with pytest.raises(err):
        port.sorted_nms(boxes, valid, 0.5, k)


def test_cpu_tensors_do_not_launch():
    before = port.launches
    port.sorted_nms(torch.zeros((3, 6)), torch.ones(3, dtype=torch.bool),
                    0.5, 2)
    assert port.launches == before


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not os.path.exists(tmp_path / "build")


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("nvcc", _build.sources(), "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd and "-shared" in cmd
    assert any(s.endswith("sorted_nms.cu") for s in cmd)
    # the library name follows the sources and flags
    assert _build.library_path(_build.sources()).endswith(".so")
