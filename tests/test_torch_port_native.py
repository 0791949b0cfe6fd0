"""The port's host ops (``cfun_tpu_torch/native.py`` over its own copy of
the C++ code) against the JAX package's (``cfun_tpu.native``), on the CPU.

Both libraries are loaded in this one process (ctypes' RTLD_LOCAL keeps
their symbols apart) and run with the same OpenMP thread count, so the
molds, the double-precision sums of ``volume_stats`` and the unmolds are
held bit for bit.  The sources have axes both up- and down-sampled and odd
sizes.  Against the port's NumPy mold (``data/resample.py``), the native
f32 resize agrees to 1e-5 of the source's largest magnitude (f32 rounding
of a different operation order) and the int8 wire to one int8 step.
"""

import ctypes

import numpy as np
import pytest

from cfun_tpu import native as jnative
from cfun_tpu.data.resample import resize as jax_resize
from cfun_tpu_torch import _build
from cfun_tpu_torch import native
from cfun_tpu_torch.data.mold import normalize_intensity, quantize_int8
from cfun_tpu_torch.data.resample import resize

# (source [H, W, D], molded [D, H, W]): up- and down-sampled axes, odd
# sizes
SHAPES = [((80, 72, 40), (48, 96, 64)), ((61, 37, 23), (32, 40, 24))]
SHAPE_IDS = ["80x72x40_to_48x96x64", "61x37x23_to_32x40x24"]
SCALE = 25.4  # the heart's int8 wire scale


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    assert native.num_threads() == jnative.num_threads()


def _source(shape, seed=0):
    rng = np.random.default_rng(seed)
    vol = (rng.normal(size=shape) * 50.0 + 100.0).astype(np.float32)
    h, w, d = shape
    vol[h // 4:3 * h // 4, w // 4:3 * w // 4, d // 4:3 * d // 4] += 300.0
    return vol


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("src_shape,out_shape", SHAPES, ids=SHAPE_IDS)
def test_mold_resize_matches_jax(src_shape, out_shape, normalize):
    src = _source(src_shape)
    got = native.mold_resize(src, out_shape, normalize)
    assert got.shape == out_shape and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jnative.mold_resize(src, out_shape, normalize))


@pytest.mark.parametrize("src_shape,out_shape", SHAPES, ids=SHAPE_IDS)
def test_mold_resize_q8_matches_jax(src_shape, out_shape):
    src = _source(src_shape)
    got = native.mold_resize_q8(src, out_shape, 5.0, SCALE)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(
        got, jnative.mold_resize_q8(src, out_shape, 5.0, SCALE))


@pytest.mark.parametrize("stride", [1, 523])
@pytest.mark.parametrize("src_shape,out_shape", SHAPES, ids=SHAPE_IDS)
def test_volume_stats_matches_jax(src_shape, out_shape, stride):
    src = _source(src_shape)
    assert native.volume_stats(src, stride) == \
        jnative.volume_stats(src, stride)
    if stride == 1:
        np.testing.assert_allclose(native.volume_stats(src, 1),
                                   (src.mean(dtype=np.float64),
                                    src.std(dtype=np.float64)), rtol=1e-6)


@pytest.mark.parametrize("n_slabs", [1, 3, 4])
@pytest.mark.parametrize("src_shape,out_shape",
                         [((80, 72, 40), (50, 96, 64)),
                          ((61, 37, 23), (35, 40, 24))],
                         ids=["depth50", "depth35"])
def test_mold_slab_q8_matches_jax(src_shape, out_shape, n_slabs):
    """Every slab of ``wire_slabs`` in {1, 3, 4} over a depth that 3 and
    4 do not divide (the Detector's partition), written into a view of one
    volume as the Detector does, against the JAX slabs."""
    src = _source(src_shape)
    mean, std = native.volume_stats(src)
    d = out_shape[0]
    zs = -(-d // n_slabs)
    ranges = [(z, min(zs, d - z)) for z in range(0, d, zs)]
    assert sum(zc for _, zc in ranges) == d and len(ranges) == n_slabs
    wire = np.full(out_shape, 99, np.int8)
    for z, zc in ranges:
        view = wire[z:z + zc]
        assert native.mold_slab_q8(src, out_shape, z, zc, mean, std, 5.0,
                                   SCALE, out=view) is view
        np.testing.assert_array_equal(
            view, jnative.mold_slab_q8(src, out_shape, z, zc, mean, std,
                                       5.0, SCALE))
    # with the exact stats the slabs are the one-pass wire
    exact = native.mold_resize(src, out_shape, normalize=False)
    m, s = float(exact.mean(dtype=np.float64)), float(exact.std())
    slabs = np.concatenate([native.mold_slab_q8(src, out_shape, z, zc, m, s,
                                                5.0, SCALE)
                            for z, zc in ranges])
    ref = (np.clip((exact - m) / s, -5.0, 5.0) * SCALE).astype(np.int8)
    assert int(np.abs(slabs.astype(np.int16) - ref).max()) <= 1


def test_mold_slab_q8_checks_its_arguments():
    src = _source((20, 18, 10))
    with pytest.raises(ValueError, match="inside depth"):
        native.mold_slab_q8(src, (8, 8, 8), 6, 3, 0.0, 1.0, 5.0, SCALE)
    with pytest.raises(ValueError, match="out must be"):
        native.mold_slab_q8(src, (8, 8, 8), 0, 2, 0.0, 1.0, 5.0, SCALE,
                            out=np.zeros((2, 8, 8), np.int16))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.mold_slab_q8(src.astype(np.float64), (8, 8, 8), 0, 2, 0.0,
                            1.0, 5.0, SCALE)


@pytest.mark.parametrize("src_shape,out_shape", SHAPES, ids=SHAPE_IDS)
def test_native_mold_against_numpy(src_shape, out_shape):
    """The native f32 resize against the NumPy resize to 1e-5 of the
    source's largest magnitude, and the native int8 wire against the NumPy
    one within one int8 step everywhere."""
    src = _source(src_shape)
    dt, ht, wt = out_shape
    numpy_molded = resize(src, (ht, wt, dt), order=1).transpose(2, 0, 1)
    got = native.mold_resize(src, out_shape, normalize=False)
    atol = 1e-5 * float(np.abs(src).max())
    np.testing.assert_allclose(got, numpy_molded, rtol=0, atol=atol)
    numpy_wire = quantize_int8(normalize_intensity(numpy_molded), SCALE)
    wire = native.mold_resize_q8(src, out_shape, 5.0, SCALE)
    step = np.abs(wire.astype(np.int16) - numpy_wire)
    assert int(step.max()) <= 1, f"{int((step > 1).sum())} voxels off"


# the four boxes of tests/test_data_io.py's heart paste check
BOXES = ([4, 10, 9, 30, 60, 50], [0, 0, 0, 40, 64, 64], [3, 5, 7, 4, 6, 8],
         [2, 2, 2, 26, 26, 26])


@pytest.mark.parametrize("box", BOXES, ids=[str(b) for b in BOXES])
def test_unmold_labels_box_matches_jax(box):
    crop = np.random.default_rng(7).integers(0, 8, size=(24, 24, 24),
                                             dtype=np.int8)
    shape = (40, 64, 64)
    got = native.unmold_labels_box(crop, box, shape)
    np.testing.assert_array_equal(got, jnative.unmold_labels_box(crop, box,
                                                                 shape))
    z1, y1, x1, z2, y2, x2 = box
    target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
    ref = np.zeros(shape, np.int16)
    ref[z1:z1 + target[0], y1:y1 + target[1],
        x1:x1 + target[2]] = jax_resize(crop, target, order=0)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("box", [[40, 5, 5, 40, 20, 20],
                                 [3, 64, 5, 20, 64, 20],
                                 [3, 5, 64, 20, 20, 64],
                                 [40, 64, 64, 40, 64, 64]],
                         ids=["z1_at_extent", "y1_at_extent",
                              "x1_at_extent", "all_at_extent"])
def test_unmold_labels_box_guard(box, monkeypatch):
    """A clipped box that starts at the volume's extent keeps a target of
    1 voxel there.  The wrapper returns the zero volume without calling
    the library, as the NumPy paste (an empty slice) writes nothing, and
    the C function, handed the same box directly, writes nothing past the
    volume's end."""
    crop = np.random.default_rng(8).integers(1, 8, size=(24, 24, 24),
                                             dtype=np.int8)
    shape = (40, 64, 64)
    lib = native.library()
    with monkeypatch.context() as m:
        m.setattr(native, "library", lambda: pytest.fail("called the C op"))
        got = native.unmold_labels_box(crop, box, shape)
    assert got.shape == shape and not got.any()
    # the NumPy paste into the same volume writes nothing either
    ref = np.zeros(shape, np.int16)
    z1, y1, x1 = box[:3]
    ref[z1:z1 + 1, y1:y1 + 1, x1:x1 + 1] = 5
    assert not ref.any()

    n = int(np.prod(shape))
    sentinel = 0x5A5A
    buf = np.full(n + 64 * 64 * 4, sentinel, np.int16)
    out = buf[:n]
    idx = np.zeros(1, np.int32)
    lib.unmold_labels_box_i16(
        crop, 24, 24, 24, idx, idx, idx, out, *shape, *box[:3], 1, 1, 1)
    assert np.all(buf[n:] == sentinel), "wrote past the volume"
    assert np.all(out == sentinel), "wrote inside the volume"


def test_unmold_labels_box_rejects_unclipped_boxes():
    crop = np.zeros((4, 4, 4), np.int8)
    with pytest.raises(ValueError, match="not clipped"):
        native.unmold_labels_box(crop, [0, 0, 0, 41, 8, 8], (40, 64, 64))


@pytest.mark.parametrize("box", [[4, 10, 9, 30, 60, 50],
                                 [0, 0, 0, 40, 64, 64],
                                 [3, 5, 7, 4, 6, 8]])
def test_unmold_argmax_matches_jax(box):
    probs = np.random.default_rng(9).uniform(
        size=(12, 14, 10, 5)).astype(np.float32)
    shape = (40, 64, 64)
    got = native.unmold_argmax(probs, box, shape)
    assert got.dtype == np.int16 and got.shape == shape
    np.testing.assert_array_equal(got, jnative.unmold_argmax(probs, box,
                                                             shape))


def test_missing_gxx_raises(monkeypatch, tmp_path):
    """Without g++ the first call raises; nothing falls back to NumPy."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.mold_resize_q8(_source((8, 8, 8)), (4, 4, 4), 5.0, SCALE)
    assert not (tmp_path / "build").exists()


def test_host_library_name_follows_source_flags_and_cpu(monkeypatch):
    path = _build.host_library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "cpu_fingerprint", lambda: "another-cpu")
    assert _build.host_library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.host_library_path() != path


def test_libraries_are_loaded_apart():
    """The port's library and the JAX package's are two handles with
    their own symbols (ctypes' default RTLD_LOCAL)."""
    port, jax_lib = native.library(), jnative._load()
    assert port._name != jax_lib._name
    addr = ctypes.cast(port.mold_resize_q8, ctypes.c_void_p).value
    assert addr != ctypes.cast(jax_lib.mold_resize_q8, ctypes.c_void_p).value


# LiTS: (source [H, W, D], pad (H, W, D), molded [D, H, W]): smaller than
# the pad on every axis; deeper than the pad (offset 0, the extra slices
# cropped); odd sizes and odd offsets
LITS = [((50, 60, 30), (64, 72, 48), (32, 48, 48)),
        ((50, 44, 90), (64, 64, 80), (35, 40, 24)),
        ((37, 53, 21), (61, 66, 43), (21, 33, 27))]
LITS_IDS = ["inside_pad", "deeper_than_pad", "odd"]
HU = (300.0, -300.0)


def _hu_source(shape, seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.0, 250.0, size=shape).astype(np.float32)
    h, w, d = shape
    vol[h // 4:3 * h // 4, w // 4:3 * w // 4, d // 4:3 * d // 4] = -150.0
    return vol


def _offsets(src_shape, pad):
    return tuple(max(0, (p - s) // 2) for s, p in zip(src_shape, pad))


@pytest.mark.parametrize("src_shape,pad,out_shape", LITS, ids=LITS_IDS)
def test_lits_mold_matches_jax(src_shape, pad, out_shape):
    src = _hu_source(src_shape)
    off = _offsets(src_shape, pad)
    got = native.lits_mold(src, pad, out_shape, off, HU)
    assert got.shape == out_shape and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jnative.lits_mold(src, pad, out_shape, off, HU))
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("n_slabs", [1, 3, 4])
@pytest.mark.parametrize("src_shape,pad,out_shape", LITS, ids=LITS_IDS)
def test_lits_mold_slab_q8_matches_jax(src_shape, pad, out_shape, n_slabs):
    """Every slab of the Detector's partition, written into a view of one
    volume, against the JAX slabs; together they are the one-pass mold
    x127 truncated."""
    src = _hu_source(src_shape)
    off = _offsets(src_shape, pad)
    d = out_shape[0]
    zs = -(-d // n_slabs)
    ranges = [(z, min(zs, d - z)) for z in range(0, d, zs)]
    assert sum(zc for _, zc in ranges) == d and len(ranges) == n_slabs
    wire = np.full(out_shape, 99, np.int8)
    for z, zc in ranges:
        view = wire[z:z + zc]
        assert native.lits_mold_slab_q8(src, pad, out_shape, off, z, zc, HU,
                                        127.0, out=view) is view
        np.testing.assert_array_equal(
            view, jnative.lits_mold_slab_q8(src, pad, out_shape, off, z, zc,
                                            HU, 127.0))
    ref = (native.lits_mold(src, pad, out_shape, off, HU) * 127.0
           ).astype(np.int8)
    np.testing.assert_array_equal(wire, ref)


def test_lits_mold_checks_its_arguments():
    src = _hu_source((20, 18, 10))
    with pytest.raises(ValueError, match="inside depth"):
        native.lits_mold_slab_q8(src, (24, 24, 16), (8, 8, 8), (2, 3, 3), 6,
                                 3, HU, 127.0)
    with pytest.raises(ValueError, match="out must be"):
        native.lits_mold_slab_q8(src, (24, 24, 16), (8, 8, 8), (2, 3, 3), 0,
                                 2, HU, 127.0,
                                 out=np.zeros((2, 8, 8), np.int16))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.lits_mold_slab_q8(src.astype(np.float64), (24, 24, 16),
                                 (8, 8, 8), (2, 3, 3), 0, 2, HU, 127.0)
    with pytest.raises(ValueError, match="centre-pad"):
        native.lits_mold(src, (24, 24, 16), (8, 8, 8), (2, 3, 16), HU)


def _label_maps(rng):
    """(labels [Dm, Hm, Wm], mz, my, mx): upsampling runs, as the LiTS
    unmold makes, and random non-monotone maps."""
    lab = rng.integers(0, 3, size=(24, 40, 40), dtype=np.int8)
    return lab, [
        (np.repeat(np.arange(24), 3)[:50], np.repeat(np.arange(40), 2)[:64],
         np.repeat(np.arange(40), 2)[:64]),
        (rng.integers(0, 24, 50), rng.integers(0, 40, 64),
         rng.integers(0, 40, 64))]


def test_unmold_nearest_labels_matches_jax():
    rng = np.random.default_rng(7)
    lab, maps = _label_maps(rng)
    for mz, my, mx in maps:
        got = native.unmold_nearest_labels(lab, mz, my, mx)
        assert got.shape == (64, 64, 50) and got.dtype == np.int16
        np.testing.assert_array_equal(
            got, jnative.unmold_nearest_labels(lab, mz, my, mx))
        ref = np.take(np.take(np.take(lab, mz, 0), my, 1), mx, 2)
        np.testing.assert_array_equal(got, ref.transpose(1, 2, 0))


@pytest.mark.parametrize("axis,value", [(0, 24), (1, 40), (2, -1), (2, 4000)],
                         ids=["mz_past_depth", "my_past_height",
                              "mx_negative", "mx_far_past_width"])
def test_unmold_nearest_labels_guard(axis, value, monkeypatch):
    """An index map that steps outside the molded volume is refused before
    the C call (it would read past the label buffer); the C function,
    handed the same map directly, writes nothing."""
    rng = np.random.default_rng(9)
    lab, maps = _label_maps(rng)
    maps = [np.array(m, np.int32) for m in maps[0]]
    maps[axis][len(maps[axis]) // 2] = value
    lib = native.library()
    with monkeypatch.context() as m:
        m.setattr(native, "library", lambda: pytest.fail("called the C op"))
        with pytest.raises(ValueError, match="outside the molded axis"):
            native.unmold_nearest_labels(lab, *maps)
    mz, my, mx = maps
    sentinel = 0x5A5A
    out = np.full((my.size, mx.size, mz.size), sentinel, np.int16)
    lib.unmold_nearest_i16(lab, *lab.shape, mz, my, mx, out, my.size,
                           mx.size, mz.size)
    assert np.all(out == sentinel), "wrote with an out-of-range map"
