"""The port's roofline accounting (``cfun_tpu_torch/utils/roofline.py``)
against the JAX package's (``cfun_tpu/utils/roofline.py``) on the CPU.

``cost_of`` counts over one eager run (FlopCounterMode and a dispatch
mode for bytes) where the JAX package asks XLA's cost analysis: on a
matmul both give the same FLOPs and bytes, on a VALID convolution the
same FLOPs and bytes; on a SAME convolution the port counts every tap
(2 * 27 * C_in * C_out * V) and XLA only the in-bounds ones, so XLA's
count is at most the port's.  The tiny configuration's trunk and dense
U-Net read the analytic sum over their convolutions (2 * k_d * k_h * k_w
* C_in * C_out * V_out each), on the CPU and on ``meta`` alike, and the
fused U-Net (through K2's plain version on the CPU) reads the dense
count.  ``segment_report`` is the JAX one's dict for equal peaks (the JAX
module's ``PEAKS`` patched for the test alone); ``time_amortized``,
``measure_dispatch_floor`` and the chain hold the JAX tests' assertions
(tests/test_roofline.py:68-91); ``packed_infer_program`` gives the
buffer ``Detector.infer`` gives.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfun_tpu.utils import roofline as jroofline
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.inference import Detector
from cfun_tpu_torch.models import cfun
from cfun_tpu_torch.models.heads import apply_mask_head
from cfun_tpu_torch.utils import roofline


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 8, 16, 16, 16)).astype(np.float32)  # NCDHW
    w = rng.normal(size=(16, 8, 3, 3, 3)).astype(np.float32)  # OIDHW
    return x, w


def _xla_conv_cost(x, w, padding):
    def conv(a, k):
        return jax.lax.conv_general_dilated(
            a, k, (1, 1, 1), padding,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    return jroofline.cost_of(conv, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                             jnp.asarray(w.transpose(2, 3, 4, 1, 0)))


def test_cost_of_matmul_equals_xla():
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    want = jroofline.cost_of(lambda a: a @ a, jnp.asarray(x))
    got = roofline.cost_of(lambda a: a @ a, torch.from_numpy(x))
    assert got == want
    assert got["flops"] == 2 * 64 ** 3


def test_cost_of_valid_conv_equals_xla():
    x, w = _conv_inputs()
    want = _xla_conv_cost(x, w, "VALID")
    got = roofline.cost_of(F.conv3d, torch.from_numpy(x), torch.from_numpy(w))
    assert got["flops"] == want["flops"] == 2 * 27 * 8 * 16 * 14 ** 3
    assert got["bytes_accessed"] == want["bytes_accessed"]


def test_cost_of_same_conv_counts_every_tap():
    x, w = _conv_inputs()
    want = _xla_conv_cost(x, w, "SAME")
    got = roofline.cost_of(lambda a, k: F.conv3d(a, k, padding=1),
                           torch.from_numpy(x), torch.from_numpy(w))
    assert got["flops"] == 2 * 27 * 8 * 16 * 16 ** 3
    assert want["flops"] <= got["flops"]


def test_cost_of_counts_the_backward():
    """Forward and backward: a matmul's two gradient products add 2x."""
    a = torch.randn(32, 48, requires_grad=True)
    b = torch.randn(48, 16, requires_grad=True)

    def step(a, b):
        torch.autograd.grad(torch.sum(a @ b), [a, b])

    assert roofline.cost_of(step, a, b)["flops"] == 3 * 2 * 32 * 48 * 16


# ---- the tiny configuration's segments --------------------------------


def _trunk_levels(cfg):
    """Output voxels of every trunk conv leaf, by the stage it sits in:
    the stem at 1/2 a side, C2 and P2 at 1/8, C3 and P3 at 1/16; the RPN
    runs on both pyramid levels."""
    v = int(np.prod(cfg.image_shape))

    def level(path):
        if path.startswith("backbone/stem_conv"):
            return [v // 8]
        if path.startswith(("backbone/c2", "fpn/p2")):
            return [v // 8 ** 3]
        if path.startswith(("backbone/c3", "fpn/p3")):
            return [v // 16 ** 3]
        if path.startswith("rpn/"):
            return [v // 8 ** 3, v // 16 ** 3]
        return None

    return level


# the level each U-Net conv writes at (level l holds crop / 8^(l - 1)
# voxels; 0 is the finetune head's 2x output)
UNET_LEVELS = {"c1_1": 1, "c1_2": 1, "c1_lrelu_conv": 1, "c2_down": 2,
               "c2_conv": 2, "c3_down": 3, "c3_conv": 3, "c4_down": 4,
               "c4_conv": 4, "c5_down": 5, "c5_conv": 5, "l0_up_conv": 4,
               "l0_conv": 4, "l1_conv": 4, "l1_reduce": 4, "l1_up_conv": 3,
               "l2_conv": 3, "l2_reduce": 3, "l2_up_conv": 2, "l3_conv": 2,
               "l3_reduce": 2, "l3_up_conv": 1, "l4_conv": 1, "l4_out": 1,
               "ds2": 3, "ds3": 2, "out_upscale": 0}
# the context levels' double conv runs its one weight twice
UNET_TWICE = {f"c{lvl}_conv" for lvl in (2, 3, 4, 5)}


def _unet_levels(crop, stage):
    """Output voxels of every U-Net conv leaf, once a use, at a crop of
    ``crop`` voxels (the upscale head runs at 'finetune' only)."""
    def level(path):
        name = path.split("/")[2]
        if name == "out_upscale" and stage != "finetune":
            return []
        uses = 2 if name in UNET_TWICE else 1
        return [crop * 8 // 8 ** UNET_LEVELS[name]] * uses

    return level


def _analytic_flops(params, level, prefix):
    total = 0
    for path, w in weights._leaves(params).items():
        if path.startswith(prefix) and path.endswith("/w") and w.dim() == 5:
            total += sum(2 * int(np.prod(w.shape)) * n
                         for n in level(path))
    return total


def _meta(params):
    return weights._unflatten({k: torch.empty_like(v, device="meta")
                               for k, v in weights._leaves(params).items()})


@pytest.fixture(scope="module")
def tiny():
    cfg = pconfig.tiny_config()
    return cfg, weights.init_params(cfg, seed=0)


def test_trunk_cost_is_the_conv_sum(tiny):
    cfg, params = tiny
    image = torch.randn(1, 1, *cfg.image_shape)
    got = roofline.cost_of(cfun.apply_trunk, params, image, cfg)
    want = sum(_analytic_flops(params, _trunk_levels(cfg), p)
               for p in ("backbone/", "fpn/", "rpn/"))
    assert got["flops"] == want > 0
    on_meta = roofline.cost_of(cfun.apply_trunk, _meta(params),
                               image.to("meta"), cfg)
    assert on_meta == got


@pytest.mark.parametrize("impl", ["explicit", "phase"])
@pytest.mark.parametrize("stage", ["beginning", "finetune"])
def test_dense_unet_cost_is_the_conv_sum(stage, impl):
    """Both forms of the up-convs and the finetune head (the train step's
    explicit ones, the served phase ones): a phase up-conv is one 3^3 conv
    to 8 x C_out phases at its input's voxels, the explicit one's FLOPs;
    the phase head (``nn.upsample2_conv_residual``) a 3^3 conv to 8 x C_out
    phases at the crop's voxels where the explicit head is a 5^3 conv at
    8x the voxels."""
    cfg = pconfig.tiny_config(stage)
    params = weights.init_params(cfg, seed=0)
    crops = torch.randn(2, 1, *cfg.mask_pool_size)
    crop = int(np.prod(cfg.mask_pool_size))

    def head(p, c):
        return apply_mask_head(p["mask"], c, stage=stage, head_impl=impl,
                               up_impl=impl)

    got = roofline.cost_of(head, params, crops)
    want = 2 * _analytic_flops(params, _unet_levels(crop, stage),
                               "mask/unet/")
    if stage == "finetune" and impl == "phase":
        c_out, c_in = params["mask"]["unet"]["out_upscale"]["w"].shape[:2]
        want += 2 * 2 * (27 - 125) * 8 * c_in * c_out * crop
    assert got["flops"] == want > 0
    assert roofline.cost_of(head, _meta(params), crops.to("meta")) == got


def test_fused_unet_reads_the_dense_count():
    """The fused U-Net through K2's plain version counts the convolutions
    the dense form counts (K2 itself, launched through ctypes on a card,
    is not dispatched: a fused segment is counted on its dense form)."""
    cfg = pconfig.tiny_config(compute_dtype="bfloat16")
    params = weights.init_params(cfg, seed=0)
    crops = torch.randn(1, 1, 32, 32, 32)

    def head(fused):
        return lambda p, c: apply_mask_head(p["mask"], c, stage="beginning",
                                            dtype=torch.bfloat16, fused=fused)

    fused = roofline.cost_of(head(True), params, crops)
    dense = roofline.cost_of(head(False), params, crops)
    assert fused["flops"] == dense["flops"] > 0


# ---- the report, the card's key, the timing ---------------------------

REPORTS = [(0.1, 1e12, 8.19e10), (0.1, 1e9, 1e9), (0.1, float("nan"),
                                                   float("nan")),
           (0.0, 5e9, 1e8), (0.0, 5e9, float("nan")), (2.5e-3, 3.3e11,
                                                       2.2e9)]


@pytest.mark.parametrize("gen", ["h100_sxm", "cpu"])
@pytest.mark.parametrize("seconds,flops,nbytes", REPORTS)
def test_segment_report_equals_jax(monkeypatch, gen, seconds, flops, nbytes):
    monkeypatch.setitem(jroofline.PEAKS, gen, dict(roofline.PEAKS[gen]))
    got = roofline.segment_report(seconds, flops, nbytes, gen=gen)
    assert got == jroofline.segment_report(seconds, flops, nbytes, gen=gen)
    assert json.loads(json.dumps(got, allow_nan=False)) == got


def test_segment_report_math_on_h100_peaks():
    # 1 TFLOP in 0.1 s = 10 TFLOP/s of the 989 peak; 335 GB in 0.1 s is
    # the 3.35 TB/s peak
    rep = roofline.segment_report(0.1, 1e12, 3.35e11, gen="h100_sxm")
    assert rep["tflops_per_s"] == pytest.approx(10.0)
    assert rep["mfu"] == pytest.approx(1e13 / 989e12, abs=1e-4)
    assert rep["hbm_bw_util"] == pytest.approx(1.0, abs=1e-4)


def test_peaks_hold_the_card_rows_only():
    assert sorted(roofline.PEAKS) == ["cpu", "h100_sxm"]
    assert roofline.PEAKS["h100_sxm"] == {"flops_bf16": 989e12,
                                          "hbm_bw": 3.35e12}
    assert all(math.isnan(v) for v in roofline.PEAKS["cpu"].values())


def test_chip_generation():
    assert roofline.chip_generation("cpu") == "cpu"
    assert roofline.chip_generation(torch.device("cpu")) == "cpu"
    assert roofline.generation_of_name("NVIDIA H100 80GB HBM3") == "h100_sxm"
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-40GB"):
        roofline.generation_of_name("NVIDIA A100-SXM4-40GB")


def test_time_amortized_separates_dispatch():
    x = torch.ones(64, 64)
    tm = roofline.time_amortized(lambda a: torch.sum(a @ a), (x,),
                                 device="cpu", reps=3, chain=4)
    assert 0.0 <= tm["kernel_s"] <= tm["single_s"] + 1e-12
    assert tm["dispatch_s"] >= 0.0
    assert tm["kernel_s"] + tm["dispatch_s"] == pytest.approx(tm["single_s"])
    assert tm["chain"] == 4 and "replay_s" not in tm


def test_chain_preserves_value():
    x = torch.full((8, 8), 2.0)
    chained = roofline.chain_graph(torch.sum, (x,), 5, "cpu")
    chained()
    assert [float(v) for v in chained.outputs] == [128.0] * 5


def test_measure_dispatch_floor_nonnegative():
    assert roofline.measure_dispatch_floor("cpu", reps=3) >= 0.0


def test_packed_infer_program_is_the_detectors():
    """The program under ``packed_infer_chain`` (tiny heart configuration
    on the packed fast path, on the CPU) returns the buffer
    ``Detector.infer`` returns, and the chain times it."""
    cfg = pconfig.tiny_config(detection_max_instances=1,
                              wire_image_dtype="int8", fast_unmold=True,
                              device_normalize=True)
    params = weights.init_params(cfg, seed=0)
    params["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
    det = Detector(cfg, params, device="cpu", native=False)
    d, h, w = cfg.image_shape
    vol = np.random.default_rng(3).normal(size=(h + 16, w, d + 8)).astype(
        np.float32)
    wire, window, _ = det.mold(vol)
    fn, args = roofline.packed_infer_program(det, vol, molded=(wire, window))
    got = fn(*args)
    want = det.infer(wire, window)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    tm = roofline.packed_infer_chain(det, vol, reps=2, chain=2,
                                     molded=(wire, window))
    assert tm["chain"] == 2 and 0.0 <= tm["kernel_s"] <= tm["single_s"]
