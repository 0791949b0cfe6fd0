"""The port's inference graph with the fused U-Net (``Config.pallas_unet``)
against the JAX package's, on tiny_config in bfloat16 on the CPU, at
stages 'beginning' and 'finetune', with shared weights
(tests/torch_port_params.py) and the heart inference overrides.

The JAX graph calls its Pallas conv kernel without ``interpret``, which
has no CPU path, so the JAX side runs with
``cfun_tpu.ops.pallas_conv.fused_conv3d`` wrapped to force interpret mode
(``apply_unet_fused`` imports it at call time).  NMS runs as the scan on
the JAX side and as the plain K1 on the port's.  The JAX graph runs
eagerly, op by op, as the port does: under ``jax.jit`` XLA's CPU backend
fuses ops and rounds bf16 at other places, and with random
weights the tiny trunk's proposals are near-tied, so that rounding alone
picks another detection (it did, with the same inputs).

Criteria: detections and ``det_valid`` equal (the trunk, RoIAlign,
classifier and refinement are the same code in both stages and the boxes
are rounded voxels; scores to rtol 1e-2, two bf16 ulps).  Labels: both
fused graphs round bf16 in other places than each other, as in
tests/test_torch_port_unet_fused.py, whose criterion allows ~1% of argmax
flips against an f32 reference; on top the 2x trilinear upsample spreads a
flip over its neighbours.  So the fast-path labels must agree on >= 97%
of voxels.  At 'finetune' the label volume is the U-Net's own 2x output:
no device upsample is left to run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.config import tiny_config
from cfun_tpu.models import cfun as jcfun
from cfun_tpu.ops import pallas_conv as jconv
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch.models import cfun as tcfun
from cfun_tpu_torch.ops import fused_conv as k2
from cfun_tpu_torch.weights import params_from_numpy
from torch_port_params import jax_params

FUSED = dict(wire_image_dtype="int8", device_normalize=True,
             fast_unmold=True, detection_max_instances=1, approx_topk=False,
             nms_backend="scan", compute_dtype="bfloat16", pallas_unet=True)


@pytest.fixture(scope="module", params=["beginning", "finetune"])
def fused_run(request):
    stage = request.param
    jcfg = tiny_config(stage, **FUSED)
    pcfg = pconfig.tiny_config(stage, **FUSED)
    jp = jax_params(jcfg, 0)
    tp = params_from_numpy(jp, pcfg)
    rng = np.random.default_rng(0)
    d, h, w = jcfg.image_shape
    img = rng.normal(size=(d, h, w)).astype(np.float32)
    img[8:24, 16:48, 20:44] += 3.0
    img = (np.clip(img, -5, 5) * jcfg.wire_int8_scale).astype(np.int8)
    anchors = config_anchors(jcfg)
    win = np.array([0, 0, 0, d, h, w], np.float32)
    pallas = jconv.fused_conv3d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "fused_conv3d",
                   lambda *a, **k: pallas(*a, **dict(k, interpret=True)))
        jout = jcfun.infer_forward(jp, jnp.asarray(img)[None, ..., None],
                                   jnp.asarray(anchors), jnp.asarray(win),
                                   cfg=jcfg)
        jout = jax_np(jout)
    before = k2.cpu_calls
    tout = tcfun.infer_forward(tp, torch.from_numpy(img)[None, None],
                               torch.from_numpy(anchors),
                               torch.from_numpy(win), pcfg)
    return stage, jout, tout, k2.cpu_calls - before


def jax_np(out):
    return type(out)(*(None if v is None else np.asarray(v) for v in out))


def test_fused_graph_launches_k2(fused_run):
    _, _, _, calls = fused_run
    assert calls == 4


def test_fused_graph_detections(fused_run):
    _, jout, tout, _ = fused_run
    np.testing.assert_array_equal(tout.det_valid.numpy(), jout.det_valid)
    assert bool(jout.det_valid.any()), "no detection to compare"
    td, jd = tout.detections.numpy(), jout.detections
    np.testing.assert_array_equal(td[:, :7], jd[:, :7])
    np.testing.assert_allclose(td[:, 7], jd[:, 7], rtol=1e-2)


def test_fused_graph_labels(fused_run):
    stage, jout, tout, _ = fused_run
    want = jout.mask_labels
    got = tout.mask_labels.numpy()
    assert got.shape == want.shape == (1, 32, 32, 32)
    assert got.dtype == np.int8
    agree = float((got == want).mean())
    assert agree >= 0.97, f"{stage}: labels agree on {agree:.5f} of voxels"
