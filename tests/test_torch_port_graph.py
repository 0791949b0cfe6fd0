"""The port's whole inference graph (``models/cfun.py::infer_forward``)
against the JAX package's, on tiny_config (float32) on the CPU, with shared
weights (tests/torch_port_params.py, converted by
``weights.params_from_numpy``).

Two configurations: ``exact_reference_overrides()`` (probability stack
out) and the heart inference overrides (int8 wire, device_normalize,
fast_unmold, one detection).  The JAX side runs the scan NMS: its Pallas
kernel has no CPU path outside interpret mode, and
tests/test_pallas_nms.py holds the two to identical keep-sets.

Criteria: detections and
``det_valid`` equal (boxes are rounded voxels; scores to rtol 1e-5);
fast-path labels agree on >= 99.9% of voxels; the exact path's float16
probabilities within 1e-3 (two float16 ulps at 0.5); packed buffers decode
identically through both ``unpack_fast_output``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.config import exact_reference_overrides, tiny_config
from cfun_tpu.models import cfun as jcfun
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch.models import cfun as tcfun
from cfun_tpu_torch.weights import params_from_numpy
from torch_port_params import jax_params

HEART = dict(wire_image_dtype="int8", device_normalize=True,
             fast_unmold=True, detection_max_instances=1, approx_topk=False,
             nms_backend="scan")


def _run(overrides, seed):
    jcfg = tiny_config(**overrides)
    pcfg = pconfig.tiny_config(**overrides)
    jp = jax_params(jcfg, seed)
    tp = params_from_numpy(jp, pcfg)
    rng = np.random.default_rng(seed)
    d, h, w = jcfg.image_shape
    img = rng.normal(size=(d, h, w)).astype(np.float32)
    img[8:24, 16:48, 20:44] += 3.0
    if jcfg.wire_image_dtype == "int8":
        img = (np.clip(img, -5, 5) * jcfg.wire_int8_scale).astype(np.int8)
    anchors = config_anchors(jcfg)
    win = np.array([0, 0, 0, d, h, w], np.float32)
    jout = jax.jit(lambda p, i, a, wn: jcfun.infer_forward(
        p, i, a, wn, cfg=jcfg))(jp, jnp.asarray(img)[None, ..., None],
                                jnp.asarray(anchors), jnp.asarray(win))
    tout = tcfun.infer_forward(tp, torch.from_numpy(img)[None, None],
                               torch.from_numpy(anchors),
                               torch.from_numpy(win), pcfg)
    return jcfg, jout, tout


@pytest.fixture(scope="module", params=[0, 1])
def heart_run(request):
    return _run(HEART, request.param)


@pytest.fixture(scope="module")
def exact_run():
    return _run(exact_reference_overrides(), 0)


def _check_detections(jout, tout):
    jd, td = np.asarray(jout.detections), tout.detections.numpy()
    np.testing.assert_array_equal(tout.det_valid.numpy(),
                                  np.asarray(jout.det_valid))
    np.testing.assert_array_equal(td[:, :7], jd[:, :7])
    np.testing.assert_allclose(td[:, 7], jd[:, 7], rtol=1e-5)
    assert bool(np.asarray(jout.det_valid).any()), "no detection to compare"


def test_exact_detections(exact_run):
    _, jout, tout = exact_run
    _check_detections(jout, tout)


def test_exact_mask_probs(exact_run):
    _, jout, tout = exact_run
    want = np.asarray(jout.mask_probs).astype(np.float32)
    got = tout.mask_probs.float().numpy()
    assert got.shape == want.shape and tout.mask_labels is None
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_heart_detections(heart_run):
    _, jout, tout = heart_run
    _check_detections(jout, tout)


def test_heart_fast_labels(heart_run):
    _, jout, tout = heart_run
    want = np.asarray(jout.mask_labels)
    got = tout.mask_labels.numpy()
    assert got.shape == want.shape and got.dtype == np.int8
    agree = float((got == want).mean())
    assert agree >= 0.999, f"labels agree on {agree:.5f} of voxels"


def test_heart_packed_bytes(heart_run):
    jcfg, jout, tout = heart_run
    jbuf = np.asarray(jcfun.pack_fast_output(jout))
    tbuf = tcfun.pack_fast_output(tout).numpy()
    assert tbuf.dtype == np.int8 and tbuf.shape == jbuf.shape
    shape = (1, *(2 * p for p in jcfg.mask_pool_size))
    # the port's bytes decode the same through both unpackers
    a = jcfun.unpack_fast_output(tbuf, 1, shape)
    b = tcfun.unpack_fast_output(tbuf, 1, shape)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b[2], tout.mask_labels.numpy())
    # and the JAX bytes decode the same through the port's unpacker
    c = tcfun.unpack_fast_output(jbuf, 1, shape)
    np.testing.assert_array_equal(c[0], np.asarray(jout.detections))
    np.testing.assert_array_equal(c[2], np.asarray(jout.mask_labels))


@pytest.mark.parametrize("bits", [2, 4])
def test_pack_roundtrip(bits):
    rng = np.random.default_rng(3)
    out = tcfun.InferOut(
        torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32)),
        torch.tensor([True, False, True]), None,
        torch.from_numpy(rng.integers(0, 2 ** bits, size=(3, 4, 6, 8))
                         .astype(np.int8)))
    buf = tcfun.pack_fast_output(out, bits=bits).numpy()
    jbuf = np.asarray(jcfun.pack_fast_output(jcfun.InferOut(
        jnp.asarray(out.detections.numpy()), jnp.asarray(out.det_valid),
        None, jnp.asarray(out.mask_labels.numpy())), bits=bits))
    np.testing.assert_array_equal(buf, jbuf)
    det, kept, labels = tcfun.unpack_fast_output(buf, 3, (3, 4, 6, 8), bits)
    np.testing.assert_array_equal(det, out.detections.numpy())
    np.testing.assert_array_equal(kept, out.det_valid.numpy())
    np.testing.assert_array_equal(labels, out.mask_labels.numpy())


def test_overlap_paste_configs_raise():
    """The configs the port once refused (``fast_unmold`` with more than
    one instance) take the device overlap paste, as in JAX: no error, and
    the graph's labels are the [D, H, W] molded volume, agreeing with the
    JAX graph's on >= 99.9% of voxels, with the same detections."""
    over = dict(HEART, detection_max_instances=4)
    jcfg, jout, tout = _run(over, 0)
    assert tcfun.uses_overlap_paste(pconfig.tiny_config(**over))
    _check_detections(jout, tout)
    assert int(tout.det_valid.sum()) >= 2, "fewer than two to paste"
    want = np.asarray(jout.mask_labels)
    got = tout.mask_labels.numpy()
    assert got.shape == want.shape == jcfg.image_shape
    assert got.dtype == np.int8 and tout.mask_probs is None
    agree = float((got == want).mean())
    assert agree >= 0.999, f"labels agree on {agree:.5f} of voxels"
