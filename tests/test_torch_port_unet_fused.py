"""The port's fused U-Net (``models/unet3d.py::apply_unet_fused``, CPU
tensors: the plain version of K2) against the JAX package's
``apply_unet_fused`` with the Pallas kernel in interpret mode, at stages
'beginning' and 'finetune', on tiny_config's U-Net (base 4, 4 classes, a
16^3 crop) with shared weights (tests/torch_port_params.py).  At
``min_fused_voxels=4096`` level 1 (16^3) fuses: ``c1_2``,
``c1_lrelu_conv``, ``l3_up_conv`` and ``l4_conv``, 4 calls of K2.

Criterion (that of tests/test_pallas_conv.py:72-99): the two frameworks
round bf16 at other places, so both fused graphs are held against the
JAX package's dense f32 ``apply_unet``.  The port's mean error must be at
most 1.5 x the JAX fused graph's + 1e-3, and its argmax agreement with
the f32 reference at least the JAX fused graph's - 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.config import tiny_config
from cfun_tpu.models.unet3d import apply_unet as jax_unet
from cfun_tpu.models.unet3d import apply_unet_fused as jax_unet_fused
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch.models.heads import apply_mask_head
from cfun_tpu_torch.models.unet3d import apply_unet_fused
from cfun_tpu_torch.ops import fused_conv as k2
from cfun_tpu_torch.weights import params_from_numpy
from torch_port_params import jax_params


@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_config()
    jp = jax_params(jcfg, 0)
    tp = params_from_numpy(jp, pconfig.tiny_config())
    x = np.random.default_rng(5).normal(size=(1, 16, 16, 16, 1))
    return jp["mask"]["unet"], tp["mask"], x.astype(np.float32)


def _ncdhw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


@pytest.mark.parametrize("stage", ["beginning", "finetune"])
def test_unet_fused_matches_jax_fused(shared, stage):
    jp, tp, x = shared
    ref32 = np.asarray(jax.jit(lambda p, v: jax_unet(
        p, v, stage=stage, dtype=jnp.float32))(jp, jnp.asarray(x)))
    jfused = np.asarray(jax_unet_fused(jp, jnp.asarray(x), stage=stage,
                                       interpret=True), np.float32)
    before = k2.cpu_calls
    tfused = apply_unet_fused(tp["unet"], _ncdhw(x), stage=stage)
    assert k2.cpu_calls == before + 4
    assert tfused.dtype == torch.bfloat16
    port = np.moveaxis(tfused.float().numpy(), 1, -1)
    assert port.shape == jfused.shape == ref32.shape
    assert port.shape[1] == (32 if stage == "finetune" else 16)

    jax_err = np.abs(jfused - ref32).mean()
    port_err = np.abs(port - ref32).mean()
    assert port_err <= 1.5 * jax_err + 1e-3, (port_err, jax_err)
    jax_agree = (jfused.argmax(-1) == ref32.argmax(-1)).mean()
    port_agree = (port.argmax(-1) == ref32.argmax(-1)).mean()
    assert port_agree >= jax_agree - 0.01, (port_agree, jax_agree)


def test_mask_head_fused_reaches_k2(shared):
    """``fused=True`` runs the fused graph (4 calls of K2 at this size) and
    gives its output; the dense head calls K2 never."""
    _, tp, x = shared
    crops = _ncdhw(x)
    before = k2.cpu_calls
    head = apply_mask_head(tp, crops, stage="beginning",
                           dtype=torch.bfloat16, fused=True)
    assert k2.cpu_calls == before + 4
    want = apply_unet_fused(tp["unet"], crops, stage="beginning")
    assert torch.equal(head, want)
    before = k2.cpu_calls
    apply_mask_head(tp, crops, stage="beginning", dtype=torch.bfloat16)
    assert k2.cpu_calls == before


def test_mask_head_fused_needs_bf16(shared):
    _, tp, x = shared
    with pytest.raises(ValueError, match="bfloat16"):
        apply_mask_head(tp, _ncdhw(x), stage="beginning",
                        dtype=torch.float32, fused=True)
