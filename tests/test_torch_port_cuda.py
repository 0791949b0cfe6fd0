"""The port's CUDA kernels and device path, on a card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On the GPU machine,
which has no JAX (tests/conftest.py imports it):
``python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda``.
chip_smoke.py runs the same checks at the served shapes.
"""

import numpy as np
import pytest
import torch

from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.inference import Detector
from cfun_tpu_torch.ops import fused_conv as k2
from cfun_tpu_torch.ops import sorted_nms as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _nms_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 60, size=(n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 30, size=(n, 3))], 1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(device)
    return boxes, torch.from_numpy(rng.uniform(size=n) > 0.2).to(device)


@pytest.mark.parametrize("n,k,thr", [
    (1, 1, 0.7), (65, 64, 0.3), (1000, 64, 0.7), (64, 1, 0.3),
    (4096, 4096, 0.5),
    # around the 64-box words and the kernel's staging limit
    (63, 63, 0.3), (64, 64, 0.7), (127, 1, 0.3), (128, 128, 0.7),
    (129, 64, 0.3), (1024, 1024, 0.3), (1025, 64, 0.7), (1200, 1200, 0.3),
    (4096, 1, 0.7), (4096, 64, 0.3),
    # the LiTS sites: propose and refine_detections
    (1000, 50, 0.7), (50, 10, 0.7)])
def test_kernel_matches_plain(cuda, n, k, thr):
    boxes, valid = _nms_inputs(n, n, cuda)
    before = k1.launches
    idx, keep = k1.sorted_nms(boxes, valid, thr, k)
    assert k1.launches == before + 1
    ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
    assert torch.equal(idx, ridx) and torch.equal(keep, rkeep)


def test_kernel_graph_replays_on_new_inputs(cuda):
    """One CUDA graph of the kernel, replayed on inputs copied into its
    static input: the kernel resets its own state between launches."""
    boxes, valid = _nms_inputs(1000, 1, cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k1.sorted_nms(boxes, valid, 0.7, 64)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        idx, keep = k1.sorted_nms(boxes, valid, 0.7, 64)
    for seed in (2, 3):
        new_boxes, new_valid = _nms_inputs(1000, seed, cuda)
        boxes.copy_(new_boxes)
        valid.copy_(new_valid)
        graph.replay()
        torch.cuda.synchronize()
        ridx, rkeep = k1.sorted_nms_reference(new_boxes, new_valid, 0.7, 64)
        assert torch.equal(idx, ridx) and torch.equal(keep, rkeep)


def test_kernel_on_two_streams_at_once(cuda):
    inputs = [_nms_inputs(1000, seed, cuda) for seed in (4, 5)]
    streams = [torch.cuda.Stream() for _ in inputs]
    for _ in range(3):
        outs = []
        for s, (boxes, valid) in zip(streams, inputs):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                outs.append(k1.sorted_nms(boxes, valid, 0.3, 64))
        torch.cuda.synchronize()
        for (boxes, valid), (idx, keep) in zip(inputs, outs):
            ridx, rkeep = k1.sorted_nms_reference(boxes, valid, 0.3, 64)
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


def _tiny_detector(device, **overrides):
    cfg = pconfig.tiny_config(detection_max_instances=1,
                              wire_image_dtype="int8", fast_unmold=True,
                              device_normalize=True, **overrides)
    params = weights.init_params(cfg, seed=0)
    params["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
    return Detector(cfg, params, device=device)


def _volumes(shapes, seed=7):
    rng = np.random.default_rng(seed)
    vols = []
    for i, shape in enumerate(shapes):
        v = rng.normal(size=shape).astype(np.float32)
        v[10:40, 10:40, 5:25] += 2.0 + i
        vols.append(v)
    return vols


def test_pinned_slab_uploads_match_the_cpu_mold(cuda):
    """The slab pipeline's uploads from reused page-locked buffers: each
    of four volumes in a row, molded before the last one's upload is
    read, lands on the card as the CPU mold writes it."""
    det = _tiny_detector(cuda, wire_slabs=3)
    cpu = _tiny_detector("cpu", wire_slabs=3)
    assert det._pipelined and len(det._slab_ranges()) == 3
    vols = _volumes([(60, 70, 30), (80, 96, 40), (64, 64, 32), (50, 90, 20)])
    wires = [det.mold(v)[0] for v in vols]
    for v, wire in zip(vols, wires):
        assert torch.equal(wire.cpu(), cpu.mold(v)[0])


def test_detect_stream_on_the_card(cuda):
    det = _tiny_detector(cuda, wire_slabs=2)
    vols = _volumes([(60, 70, 30), (80, 96, 40), (64, 64, 32)])
    serial = [det.detect(v) for v in vols]
    streamed = list(det.detect_stream(vols))
    assert len(streamed) == len(serial)
    for s, r in zip(streamed, serial):
        np.testing.assert_array_equal(s["mask"], r["mask"])
        np.testing.assert_array_equal(s["rois"], r["rois"])
        np.testing.assert_array_equal(s["scores"], r["scores"])


@pytest.mark.parametrize("b,c,co,d,h,w,pre_lrelu", [
    (1, 4, 4, 1, 8, 8, True), (2, 6, 5, 5, 7, 9, True),
    (2, 6, 5, 5, 7, 9, False), (1, 33, 47, 9, 9, 9, True),
    (1, 160, 160, 3, 5, 17, False), (3, 20, 20, 7, 13, 11, True),
    (1, 8, 24, 3, 5, 1, True), (1, 20, 81, 4, 9, 10, False),
    (2, 24, 161, 3, 7, 12, True), (1, 25, 24, 5, 11, 13, True),
    (1, 40, 81, 3, 6, 1, True),
    # the LiTS U-Net's batch of 10 and its channel counts (C_out 128 is
    # split over blockIdx.y), at a small crop
    (10, 32, 32, 8, 20, 20, True), (10, 64, 128, 4, 10, 10, True),
    (10, 128, 64, 4, 10, 10, False)])
def test_fused_conv_matches_plain(cuda, b, c, co, d, h, w, pre_lrelu):
    """K2 against its plain version: y within one bf16 ulp of its
    magnitude plus 2^-16 of the sum of |terms| (the f32 sums'
    reassociation), moments to 1e-4, and two launches bit-equal."""
    g = torch.Generator().manual_seed(b * 1000 + c)
    x = torch.randn((b, c, d, h, w), generator=g).to(torch.bfloat16)
    wt = 0.1 * torch.randn((co, c, 3, 3, 3), generator=g)
    scale = 1.0 + 0.2 * torch.randn((b, c), generator=g)
    shift = 0.3 * torch.randn((b, c), generator=g)
    args = [t.to(cuda) for t in (x, wt, scale, shift)]
    before = k2.launches
    shape_before = k2.launch_shapes[(b, c, co, d, h, w)]
    y, s = k2.fused_conv3d(*args, pre_lrelu=pre_lrelu)
    y2, s2 = k2.fused_conv3d(*args, pre_lrelu=pre_lrelu)
    assert k2.launches == before + 2
    assert k2.launch_shapes[(b, c, co, d, h, w)] == shape_before + 2
    assert torch.equal(y.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(s, s2)
    ry, rs = k2.fused_conv3d_reference(*args, pre_lrelu=pre_lrelu)
    act = args[0].float() * args[2][:, :, None, None, None] + \
        args[3][:, :, None, None, None]
    if pre_lrelu:
        act = torch.nn.functional.leaky_relu(act, 0.01)
    y_abs = torch.nn.functional.conv3d(
        act.abs(), args[1].to(torch.bfloat16).float().abs(), padding=1)
    tol = 2.0 ** -7 * torch.maximum(y.float().abs(), ry.float().abs()) + \
        2.0 ** -16 * y_abs
    assert bool(((y.float() - ry.float()).abs() <= tol).all())
    ysum_abs = ry.float().abs().sum(dim=(2, 3, 4))
    assert bool(((s[:, 0] - rs[:, 0]).abs() <= 1e-4 * ysum_abs).all())
    assert bool(((s[:, 1] - rs[:, 1]).abs() <= 1e-4 * rs[:, 1]).all())


def test_fused_conv_rejects_noncontiguous(cuda):
    x = torch.zeros((1, 4, 8, 8, 8), dtype=torch.bfloat16, device=cuda)
    sc, sh = k2.identity_affine(1, 4, device=cuda)
    w = torch.zeros((4, 4, 3, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_conv3d(x.transpose(2, 4), w, sc, sh)


def test_fused_conv_kernel_writes_bf16_only(cuda):
    """The kernel has no f32 output; a CUDA call asking for one raises
    before any launch (the plain version on the CPU still takes it)."""
    x = torch.zeros((1, 4, 8, 8, 8), dtype=torch.bfloat16, device=cuda)
    sc, sh = k2.identity_affine(1, 4, device=cuda)
    w = torch.zeros((4, 4, 3, 3, 3), device=cuda)
    before = k2.launches
    with pytest.raises(TypeError, match="bfloat16"):
        k2.fused_conv3d(x, w, sc, sh, out_dtype=torch.float32)
    assert k2.launches == before


def _tiny_lits_detector(device, **overrides):
    cfg = pconfig.tiny_config().replace(**{**dict(
        name="lits", num_classes=3, backbone="P3D35",
        backbone_stem_kernel=(5, 7, 7), intensity_norm="hu_window",
        pad_shape=(64, 128, 128), mask_shape_override=(16, 16, 16),
        mask_pool_size=(16, 16, 16), unet_dropout_rate=0.0,
        detection_max_instances=3, wire_image_dtype="int8",
        wire_int8_scale=127.0, fast_unmold=True), **overrides})
    params = weights.init_params(cfg, seed=0)
    params["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
    return Detector(cfg, params, device=device)


def _hu_volumes(shapes, seed=5):
    rng = np.random.default_rng(seed)
    vols = []
    for shape in shapes:
        v = (300.0 + 40.0 * rng.normal(size=shape)).astype(np.float32)
        h, w, d = shape
        v[h // 5:3 * h // 5, w // 4:3 * w // 4, d // 5:7 * d // 10] = -150.0
        vols.append(v)
    return vols


def test_lits_pinned_mold_and_window_match_the_cpu(cuda):
    """The LiTS slab pipeline and the per-request window, both from reused
    page-locked buffers: four volumes of different shapes in a row, molded
    before the last one's upload is read, land on the card as the CPU
    mold writes them."""
    det = _tiny_lits_detector(cuda, wire_slabs=3)
    cpu = _tiny_lits_detector("cpu", wire_slabs=3)
    assert det._pipelined_lits and len(det._slab_ranges()) == 3
    vols = _hu_volumes([(100, 110, 50), (140, 90, 80), (64, 64, 32),
                        (90, 100, 70)])
    molded = [det.mold(v) for v in vols]
    wins = [det._device_window(w) for _, w, _ in molded]
    for v, (wire, window, _), win in zip(vols, molded, wins):
        cwire, cwindow, _ = cpu.mold(v)
        assert torch.equal(wire.cpu(), cwire)
        np.testing.assert_array_equal(window, cwindow)
        assert torch.equal(win.cpu(), torch.from_numpy(cwindow))


def test_lits_detector_card_matches_cpu(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = _tiny_lits_detector(cuda)
    vol = _hu_volumes([(100, 110, 50)])[0]
    before = k1.launches
    got = det.detect(vol)
    assert k1.launches == before + 2
    want = _tiny_lits_detector("cpu").detect(vol)
    assert len(want["scores"]) >= 2
    assert got["rois"].shape == want["rois"].shape
    assert np.abs(got["rois"] - want["rois"]).max(initial=0) <= 1
    assert got["mask"].shape == vol.shape
    assert float((got["mask"] == want["mask"]).mean()) >= 0.99


def _organ_train_batch(cfg, params, device):
    """A tiny batch whose organ sits on the port's first proposal (from
    the CPU graph), so the ROI sample has positives and the mask branch
    runs; RPN targets from ``build_rpn_targets``."""
    from cfun_tpu_torch.data.feeder import np_mask_to_extended_bbox
    from cfun_tpu_torch.models import cfun
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.data.batch import TrainBatch
    from cfun_tpu_torch.train.targets import build_rpn_targets

    d, h, w = cfg.image_shape
    image = np.random.default_rng(0).normal(size=(d, h, w)).astype(
        np.float32)
    anchors = config_anchors(cfg)
    with torch.no_grad():
        trunk = cfun.apply_trunk(params, torch.from_numpy(image)[None, None],
                                 cfg)
        props, _ = cfun.propose(trunk.rpn_logits[0], trunk.rpn_deltas[0],
                                torch.from_numpy(anchors), cfg,
                                cfg.post_nms_rois_training)
    scale = np.array([d, h, w, d, h, w], np.float32)
    box = props[0].numpy() * scale
    lo, hi = np.ceil(box[:3]).astype(int), np.floor(box[3:]).astype(int)
    labels = np.zeros((d, h, w), np.int32)
    labels[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
    gt = np_mask_to_extended_bbox(labels)
    match, deltas = build_rpn_targets(anchors, gt, cfg,
                                      np.random.default_rng(0))
    return TrainBatch(torch.from_numpy(image)[None, None],
                      torch.from_numpy(match), torch.from_numpy(deltas),
                      torch.from_numpy(gt / scale),
                      torch.from_numpy(labels)).to(device)


def test_train_step_card_matches_cpu(cuda):
    """One train step of the tiny 'finetune' config (remat U-Net, dropout
    0.6, the edge loss; float32, TF32 off) on the card and on the CPU from
    the same weights, batch and draws: K1 once at 64->32 on the card, the
    loss parts to rtol 1e-4, every updated leaf within 1e-5 of its
    largest magnitude."""
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    cfg = pconfig.tiny_config("finetune", remat_unet=True)
    draws = tstep.draw_train(cfg, torch.Generator().manual_seed(3), "cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for device in ("cpu", cuda):
            params = weights.to_device(weights.init_params(cfg, seed=0),
                                       device)
            batch = _organ_train_batch(cfg, weights.init_params(cfg, 0),
                                       device)
            init, step = tstep.make_train_step(cfg, config_anchors(cfg))
            before = k1.launches
            state, metrics = step(init(params), batch, tstep.TrainDraws(
                tstep.TargetDraws(*(u.to(device)
                                    for u in draws.targets)),
                [m.to(device) for m in draws.dropout_masks]))
            out[str(device)] = ({k: float(v) for k, v in metrics.items()},
                                {p: v.detach().cpu() for p, v in
                                 weights._leaves(state.params).items()},
                                k1.launches - before)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cparts, cparams, claunch), (gparts, gparams, glaunch) = \
        out["cpu"], out[str(cuda)]
    assert claunch == 0 and glaunch == 1
    assert cparts["mrcnn_mask_loss"] > 0 and cparts["mrcnn_mask_edge_loss"] > 0
    for k, v in cparts.items():
        np.testing.assert_allclose(gparts[k], v, rtol=1e-4, err_msg=k)
    for p, v in cparams.items():
        scale = float(v.abs().max())
        assert float((gparams[p] - v).abs().max()) <= 1e-5 * scale, p


def test_two_gloo_ranks_on_one_card_match_the_card_step(cuda):
    """A (2, 1) mesh of two gloo ranks on ``cuda:0`` (the rehearsal of two
    cards on one), tiny config, float32 with TF32 off: K1 once a step on
    each rank, the parameters bit-equal on both, and the step equal to one
    process's step on the card over the mean of the two volumes' losses
    (``batched_train_forward``): losses rtol 1e-4, every leaf within 1e-5
    of its largest magnitude (``train_tiny``'s)."""
    import torch_port_ranks as R
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.parallel.launch import launch
    from cfun_tpu_torch.parallel.mesh import stack_batches
    from cfun_tpu_torch.train import step as tstep

    cfg = pconfig.tiny_config()
    params = weights.params_to_numpy(weights.init_params(cfg, seed=0))
    batches = [R.synthetic_batch(cfg, s) for s in (0, 1)]
    draws = [tstep.draw_train(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in (5, 6)]
    np_draws = [((d.targets[0].numpy(), d.targets[1].numpy()), None)
                for d in draws]
    runs = [r["dp"] for r in launch(
        R.step_suite, 2, 1, devices=["cuda:0", "cuda:0"], backend="gloo",
        args=({"dp": (cfg, params, [batches], [np_draws], None)},))]
    assert [r["k1_launches"] for r in runs] == [1, 1]
    for p, v in runs[0]["steps"][0][1].items():
        np.testing.assert_array_equal(runs[1]["steps"][0][1][p], v, p)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
        state = init(weights.to_device(weights.params_from_numpy(params, cfg),
                                       cuda))
        flat = weights._leaves(state.params)
        paths = [p for p, v in flat.items() if v.requires_grad]
        total, parts = tstep.batched_train_forward(
            state.params, stack_batches([R.port_batch(b).to(cuda)
                                         for b in batches]),
            torch.from_numpy(config_anchors(cfg)).to(cuda), cfg,
            [tstep.TrainDraws(tstep.TargetDraws(
                *(u.to(cuda) for u in d.targets)), None) for d in draws])
        grads = torch.autograd.grad(total, [flat[p] for p in paths],
                                    allow_unused=True)
        grads = {p: torch.zeros_like(flat[p]) if g is None else g
                 for p, g in zip(paths, grads)}
        state, metrics = tstep.apply_update(
            cfg, state, grads, total.detach(),
            {k: v.detach() for k, v in parts.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    got_metrics, got_params = runs[0]["steps"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got_metrics[k], float(v), rtol=1e-4,
                                   err_msg=k)
    for p, v in weights._leaves(state.params).items():
        want = v.detach().cpu().numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got_params[p] - want).max()) <= 1e-5 * scale, p


def test_halo_primitives_on_the_card(cuda):
    """The halo exchange, the halo convs and the sharded instance norm on
    CUDA tensors of two gloo ranks on ``cuda:0`` (all_gather and
    all_reduce on the card, TF32 off), against the dense graph on the
    CPU: each gathered output and input gradient within 1e-5 of its
    largest magnitude, the weight gradients summed over the ranks."""
    import torch.nn.functional as F

    import torch_port_ranks as R
    from cfun_tpu_torch import nn as pnn
    from cfun_tpu_torch.parallel.launch import launch

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 16, 6, 5)).astype(np.float32)
    w = {k: (0.3 * rng.normal(size=(4, 3, k, k, k))).astype(np.float32)
         for k in (3, 5)}
    convs = [("k3s1", w[3], 1), ("k3s2", w[3], 2), ("k5s1", w[5], 1)]

    def halo_dense(v, h):
        vp = F.pad(v, [0, 0, 0, 0, h, h])
        return torch.cat([vp[:, :, 0:8 + 2 * h], vp[:, :, 8:16 + 2 * h]], 2)

    dense = {"halo1": (lambda v: halo_dense(v, 1), None),
             "halo2": (lambda v: halo_dense(v, 2), None),
             "inorm": (pnn.instance_norm, None)}
    for name, wk, s in convs:
        dense[name] = (lambda v, p, s=s: pnn.conv3d({"w": p}, v, stride=s),
                       wk)
    cots = {}
    for name, (fn, wk) in dense.items():
        args = [torch.from_numpy(x)] + ([torch.from_numpy(wk)]
                                        if wk is not None else [])
        cots[name] = rng.normal(size=fn(*args).shape).astype(np.float32)
    got = launch(R.primitives, 1, 2, devices=["cuda:0", "cuda:0"],
                 backend="gloo", args=(x, cots, convs))
    for name, (fn, wk) in dense.items():
        leaves = [torch.from_numpy(x).requires_grad_(True)] + (
            [torch.from_numpy(wk).requires_grad_(True)] if wk is not None
            else [])
        y = fn(*leaves)
        grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(
            cots[name])), leaves)
        pairs = [(np.concatenate([g[name][0] for g in got], 2), y),
                 (np.concatenate([g[name][1] for g in got], 2), grads[0])]
        if wk is not None:
            pairs.append((sum(g[name][2] for g in got), grads[1]))
        for have, want in pairs:
            want = want.detach().numpy()
            scale = float(np.abs(want).max())
            assert float(np.abs(have - want).max()) <= 1e-5 * scale, name


def test_time_amortized_replays_a_bf16_matmul(cuda):
    """``utils/roofline.py``'s timing on the card: a bf16 matmul chained
    through one captured CUDA graph, whose replayed outputs equal an eager
    call's, and the report against the card's peaks."""
    from cfun_tpu_torch.utils import roofline

    a = torch.randn(2048, 2048, device=cuda).to(torch.bfloat16)
    chained = roofline.chain_graph(torch.matmul, (a, a), 4, cuda)
    tm = roofline.time_amortized(torch.matmul, (a, a), device=cuda, reps=3,
                                 chained=chained)
    want = a @ a
    torch.cuda.synchronize()
    assert len(chained.outputs) == 4
    assert all(torch.equal(y, want) for y in chained.outputs)
    assert tm["chain"] == 4 and tm["replay_s"] > 0
    assert 0.0 <= tm["kernel_s"] <= tm["single_s"]
    assert tm["kernel_s"] + tm["dispatch_s"] == pytest.approx(tm["single_s"])
    cost = roofline.cost_of(torch.matmul, a, a)
    assert cost["flops"] == 2 * 2048 ** 3
    rep = roofline.segment_report(tm["replay_s"], gen=roofline.chip_generation(
        cuda), **cost)
    assert 0.0 < rep["mfu"] < 1.0
