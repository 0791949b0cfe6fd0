"""Port NMS (cfun_tpu_torch.ops.sorted_nms / ops.nms) against the JAX
package's Pallas kernel (interpret mode) and scan NMS, on the CPU.

Keep-sets must match exactly: same indices, same order, same mask.  The
CUDA kernel itself runs only on a card (tests/test_torch_port_cuda.py and
chip_smoke.py); here the wrapper takes the plain version because the
tensors lie on the CPU.
"""

import functools
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


# --- the CUDA kernel's layout, run in numpy (csrc/sorted_nms.cu) ---------
# Constants of the kernel: 64 boxes a word and a tile, 512 threads (16
# warps) a block, 66 u64 a staged tile, 96 KB of tiles staged at once.
_T, _WARPS, _TILE_STRIDE, _STAGE_BYTES = 64, 16, 66, 96 * 1024
_ALL = (1 << 64) - 1


def _tile_id(words, r, c):
    return r * words - r * (r - 1) // 2 + (c - r)


def _popc(x):
    return bin(x).count("1")


def _ffs(x):
    return (x & -x).bit_length() - 1


def _tile_over(rows, cols, thr):
    """(IoU > thr) for 64 row boxes against 64 column boxes, in the
    kernel's float32 operation order (volumes (d * h) * w precomputed, the
    zero-intersection shortcut, else the division)."""
    f32 = np.float32
    vol = lambda b: ((b[:, 3] - b[:, 0]) * (b[:, 4] - b[:, 1])) * (
        b[:, 5] - b[:, 2])
    a, b = rows[:, None, :], cols[None, :, :]
    edge = [np.maximum(np.minimum(a[..., 3 + d], b[..., 3 + d]) -
                       np.maximum(a[..., d], b[..., d]), f32(0))
            for d in range(3)]
    inter = (edge[0] * edge[1]) * edge[2]
    denom = ((vol(rows)[:, None] + vol(cols)[None, :]) - inter) + f32(1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        over = inter / denom > f32(thr)
    zero = (f32(0) > f32(thr)) & (denom == denom) & (denom != 0)
    return np.where(inter == 0, zero, over)


# row order of a tile as the warps take it (warp w: rows w, w + 16, ...)
# and the column of each ballot bit (lane l: columns l, l + 32)
_ROWS = np.array([row for warp in range(_WARPS)
                  for row in range(warp, _T, _WARPS)])
_BIT_COLS = np.concatenate([np.arange(32), np.arange(32) + 32])
_BIT = np.uint64(1) << np.arange(_T, dtype=np.uint64)


def _words(bits):
    """Ballots of [rows, 64] bits (bit b from the lane holding column
    _BIT_COLS[b]) as 64-bit words."""
    return [int(x) for x in (bits[:, _BIT_COLS].astype(np.uint64) * _BIT)
            .sum(axis=1, dtype=np.uint64)]


@functools.lru_cache(maxsize=4)
def _kernel_tiles(n, thr):
    """Phase 1 (it does not depend on k): block b decodes its tile (r, c)
    as the kernel does; warp w takes rows w, w + 16, ...; lane l columns l
    and l + 32; a row word is two ballots.  The diagonal tiles pack
    `valid`.  Returns the tile-major mask [tiles][64] and the valid
    words."""
    boxes, valid = _layout_case(n, n)
    words = -(-n // _T)
    tiles = words * (words + 1) // 2
    padded = np.zeros((words * _T, 6), np.float32)
    padded[:n] = boxes
    vpad = np.zeros(words * _T, bool)
    vpad[:n] = valid
    mask = [None] * tiles
    vwords = [0] * words
    assert sorted(_ROWS) == list(range(_T))  # every row once
    for block in range(tiles):
        rem, r = block, 0
        while rem >= words - r:
            rem -= words - r
            r += 1
        c = r + rem
        assert _tile_id(words, r, c) == block
        row_valid = _words(vpad[None, r * _T:(r + 1) * _T])[0]
        if r == c:
            vwords[r] = row_valid
        over = _tile_over(padded[r * _T:(r + 1) * _T],
                          padded[c * _T:(c + 1) * _T], thr)
        i = r * _T + _ROWS[:, None]
        live = vpad[r * _T + _ROWS][:, None]
        bits = live & (c * _T + np.arange(_T)[None, :] > i) & over[_ROWS]
        tile = [0] * _T
        for row, word in zip(_ROWS, _words(bits)):
            tile[row] = word
        mask[block] = tile
    return mask, vwords


def _kernel_sweep(mask, vwords, n, k):
    """Phase 3, the sweeping warp: tiles staged all at once or in a ring
    of two row blocks (refilled after each word, as the kernel issues
    them), suppression word w in lane w % 32, the chain over 32-bit halves
    taking the four lowest open boxes a step, outputs a word at a time at
    count + popc(kept below the bit)."""
    words = len(vwords)
    tiles = words * (words + 1) // 2
    ring = tiles * _TILE_STRIDE * 8 > _STAGE_BYTES
    slots = {}  # ring slot -> row block staged there

    def stage(b):
        if b < words:
            slots[b & 1] = b

    if ring:
        stage(0)
        stage(1)
    supp = [(~vwords[w]) & _ALL for w in range(words)]
    idx, keep = [0] * k, [False] * k
    count, w = 0, 0
    while w < words and count < k:
        if ring:
            assert slots[w & 1] == w  # the slot holds this word's row block
        row_tile = lambda ww, w=w: mask[_tile_id(words, w, ww)]
        opn = (~supp[w]) & _ALL
        if opn:
            kept, c = 0, count
            acc = {ww: 0 for ww in range(w + 1, words)}
            for h in range(2):
                o = (opn >> (32 * h)) & 0xFFFFFFFF
                while o and c < k:
                    o1 = o & (o - 1)
                    o2 = o1 & (o1 - 1)
                    o3 = o2 & (o2 - 1)
                    b0 = 32 * h + _ffs(o)
                    bs = [b0] + [32 * h + _ffs(x) if x else b0
                                 for x in (o1, o2, o3)]
                    rs = [row_tile(w)[b] for b in bs]
                    need = k - c
                    take, s, nk = [True], rs[0], 1
                    for x, b, rb in zip((o1, o2, o3), bs[1:], rs[1:]):
                        t = bool(x) and nk < need and not (s >> b) & 1
                        take.append(t)
                        if t:
                            s |= rb
                            nk += 1
                    for t, b in zip(take, bs):
                        if t:
                            kept |= 1 << b
                            for ww in acc:
                                acc[ww] |= row_tile(ww)[b]
                    opn &= ~s & _ALL
                    o = (o3 & (o3 - 1)) & ~(s >> (32 * h)) & 0xFFFFFFFF
                    c += nk
            for ww, a in acc.items():
                supp[ww] |= a
            for lane in range(_T):
                if (kept >> lane) & 1:
                    pos = count + _popc(kept & ((1 << lane) - 1))
                    idx[pos], keep[pos] = w * _T + lane, True
            count = c
        if ring and w + 2 < words:
            stage(w + 2)
        w += 1
    return idx, keep


def _layout_case(n, seed):
    """Score-sorted boxes with duplicates, integer corners and tied
    scores, ~80% valid."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 60, size=(n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 30, size=(n, 3))],
                           1).astype(np.float32)
    if n > 4:
        boxes[n // 2] = boxes[1]
        boxes[-1] = boxes[0]
        boxes[: n // 4] = np.round(boxes[: n // 4])
    order = np.argsort(-np.round(rng.uniform(size=n), 2), kind="stable")
    return boxes[order], rng.uniform(size=n) > 0.2


_LAYOUT_N = (1, 63, 64, 65, 127, 128, 129, 1000, 1024, 1025, 4096)


@pytest.mark.parametrize("n,k,thr", [
    (n, k, thr) for n in _LAYOUT_N for k in sorted({1, 10, 50, 64, n})
    for thr in (0.3, 0.7)])
def test_nms_kernel_layout_emulation_matches_plain(n, k, thr):
    """The kernel's own maps (tile per block, pairs per warp and lane,
    word and bit layout, valid packed by ballot, the staged tiles, the
    four-box chain and its stop at k) give the plain version's keep-set
    exactly."""
    boxes, valid = _layout_case(n, n)
    mask, vwords = _kernel_tiles(n, thr)
    idx, keep = _kernel_sweep(mask, vwords, n, k)
    ridx, rkeep = port.sorted_nms_reference(torch.from_numpy(boxes),
                                            torch.from_numpy(valid), thr, k)
    assert idx == ridx.tolist() and keep == rkeep.tolist()
