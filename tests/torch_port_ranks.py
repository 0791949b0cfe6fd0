"""Rank functions of the port's mesh tests (tests/test_torch_port_halo.py,
tests/test_torch_port_mesh.py), run in the ranks that
``cfun_tpu_torch.parallel.launch.launch`` spawns.  A rank imports this
module by name, so it imports only torch and the port: no JAX, no test
module.  Each function takes the rank's mesh and numpy inputs and returns
numpy (or plain) results; the tests compare them in their own process.
"""

import numpy as np
import torch

from cfun_tpu_torch import weights
from cfun_tpu_torch.ops import sorted_nms as k1
from cfun_tpu_torch.ops.anchors import config_anchors
from cfun_tpu_torch.parallel import halo
from cfun_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step
from cfun_tpu_torch.train import step as tstep
from cfun_tpu_torch.train.targets import TargetDraws


def _np(t):
    """A numpy copy (not a view of the live tensor)."""
    return t.detach().cpu().numpy().copy()


def _float32_on(device):
    """Full float32 on a card: cuDNN and matmuls without TF32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def primitives(mesh, x, cot, convs, dim=2):
    """The halo primitives on this rank's shard along ``dim`` (2 = D, 3 =
    H) of ``x`` [N, C, D, H, W] over the mesh's space group: each output
    shard and the gradients of sum(output shard * the same shard of
    ``cot[name]``) (this rank's share of the objective) with respect to
    the input shard and the conv weights.  ``convs``: (name, weight,
    stride).  Along D also the sharded instance norm; along H also
    ``gather_along``, whose output is whole and whose rank r takes
    ``cot['gather'][r]``."""
    group, dev = mesh.space_group, mesh.device
    _float32_on(dev)
    rank = torch.distributed.get_rank(group)
    out = {}

    def run(name, fn, *params, whole=False):
        xs = halo.shard_of(torch.from_numpy(x), group, dim).to(dev, copy=True)
        xs.requires_grad_(True)
        leaves = [torch.from_numpy(p).to(dev).requires_grad_(True)
                  for p in params]
        y = fn(xs, *leaves)
        c = torch.from_numpy(cot[name][rank]) if whole else \
            halo.shard_of(torch.from_numpy(cot[name]), group, dim)
        grads = torch.autograd.grad(torch.sum(y * c.to(dev)), [xs] + leaves)
        out[name] = [_np(y)] + [_np(g) for g in grads]

    for h in (1, 2):
        run(f"halo{h}", lambda v, h=h: halo.exchange_halo(v, group, h,
                                                          dim=dim))
    if dim == 2:
        run("inorm", lambda v: halo.instance_norm_sharded(v, group))
    for name, w, stride in convs:
        run(name, lambda v, p, s=stride: halo.halo_conv3d(
            {"w": p}, v, group, stride=s, dim=dim), w)
    if dim == 3:
        run("gather", lambda v: halo.gather_along(v, group, 3), whole=True)
    return out


def unet_params(unet_np):
    """The JAX package's U-Net tree (numpy) in the port's layouts."""
    return weights._unflatten({k: weights._convert(k, v) for k, v in
                               weights._leaves(unet_np).items()})


def unet_shard(mesh, unet_np, crops, cot, stage):
    """This rank's shard of the sharded U-Net's logits for ``crops`` [P, 1,
    D, H, W], and the gradients of its share of sum(logits * cot) with
    respect to the U-Net's leaves (path: numpy)."""
    params = unet_params(unet_np)
    leaves = weights._leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    y = halo.shard_map_unet(mesh, params, torch.from_numpy(crops),
                            stage=stage)
    c = halo.shard_of(torch.from_numpy(cot), mesh.space_group)
    grads = torch.autograd.grad(torch.sum(y * c), list(leaves.values()),
                                allow_unused=True)
    return _np(y), {p: None if g is None else _np(g)
                    for p, g in zip(leaves, grads)}


def mask_losses_shard(mesh, cfg, masks, pos_valid, logits):
    """The sharded mask and edge losses on this rank's shard of ``logits``
    [P, C, D, H, W], and the gradient of its share (1 / space) of mask +
    2 x edge with respect to that shard."""
    lg = halo.shard_of(torch.from_numpy(logits), mesh.space_group).clone()
    lg.requires_grad_(True)
    ml, el = halo.sharded_mask_losses(
        mesh, torch.from_numpy(masks), torch.from_numpy(pos_valid), lg, cfg,
        edge_on=True)
    (g,) = torch.autograd.grad((ml + 2.0 * el) / mesh.space, [lg])
    return float(ml), float(el), _np(g)


def trunk_split(mesh, cfg, params_np, image, misaligned):
    """``apply_trunk`` split along H over the mesh's space group on the
    whole ``image`` [1, 1, D, H, W]: the gathered maps (p2, p3, rpn_logits,
    rpn_deltas, numpy), and the error ``misaligned`` (an image whose local
    H is not a multiple of 16) raises."""
    from cfun_tpu_torch.models import cfun

    params = weights.params_from_numpy(params_np, cfg)
    with torch.no_grad():
        out = cfun.apply_trunk(params, torch.from_numpy(image), cfg,
                               group=mesh.space_group)
    try:
        cfun.apply_trunk(params, torch.from_numpy(misaligned), cfg,
                         group=mesh.space_group)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {k: _np(v) for k, v in out._asdict().items()}, refused


def halo_suite(mesh, x, cot4, cot2, convs, xh, coth4, coth2, convs_h,
               unet_case, loss_cases, trunk_case):
    """Every case of tests/test_torch_port_halo.py in one launch of four
    ranks: the primitives split along D and along H over the launch's
    (1, 4) mesh and over a (2, 2) mesh; then, on the (2, 2) mesh, row 0
    runs the sharded U-Net at both stages and row 1 the sharded mask
    losses of each form and the trunk split along H."""
    out = {"space4": primitives(mesh, x, cot4, convs),
           "space4_h": primitives(mesh, xh, coth4, convs_h, dim=3)}
    mesh22 = make_mesh(2, 2, devices="cpu")
    out["space2"] = primitives(mesh22, x, cot2, convs)
    out["space2_h"] = primitives(mesh22, xh, coth2, convs_h, dim=3)
    if mesh22.data_index == 0:
        unet_np, crops, cots = unet_case
        out["unet"] = {stage: unet_shard(mesh22, unet_np, crops, cot, stage)
                       for stage, cot in cots.items()}
    else:
        masks, pos_valid, logits, cfgs = loss_cases
        out["losses"] = {name: mask_losses_shard(mesh22, cfg, masks,
                                                 pos_valid, logits)
                         for name, cfg in cfgs.items()}
        out["trunk"] = trunk_split(mesh22, *trunk_case)
    out["space_index"] = mesh22.space_index
    return out


def port_batch(b):
    """A ``TrainBatch`` of CPU tensors from tests/torch_port_train.py's
    numpy dict."""
    return tstep.TrainBatch(image=torch.from_numpy(b["image"])[None, None],
                            rpn_match=torch.from_numpy(b["rpn_match"]),
                            rpn_deltas=torch.from_numpy(b["rpn_deltas"]),
                            gt_box_norm=torch.from_numpy(b["gt_box_norm"]),
                            labels=torch.from_numpy(b["labels"]))


def draws_from_numpy(d):
    """``TrainDraws`` from (uniforms, keep masks) numpy."""
    (u_pos, u_neg), masks = d
    return tstep.TrainDraws(
        TargetDraws(torch.from_numpy(u_pos), torch.from_numpy(u_neg)),
        None if masks is None else [torch.from_numpy(m) for m in masks])


def digest(params):
    """Every leaf of ``params`` as numpy, by path."""
    return {p: _np(v) for p, v in weights._leaves(params).items()}


def run_steps(mesh, cfg, params_np, batches, draws, layout):
    """Steps of ``make_parallel_train_step`` on ``mesh`` (or on the mesh
    ``layout`` (data, space) made here from the launch's ranks, on the
    CPU): step ``s`` gives row ``r`` ``batches[s][r]`` with
    ``draws[s][r]``.  Returns each step's metrics and parameters after
    it, and the first step's gradients as the ranks summed them."""
    from cfun_tpu_torch.parallel import mesh as pmesh

    if layout is not None:
        mesh = make_mesh(*layout, devices="cpu")
    dev = mesh.device
    _float32_on(dev)
    summed = {}
    reduce = pmesh.all_reduce_gradients

    def recording(grads, group=None):
        out = reduce(grads, group)
        if not summed:
            summed.update({p: _np(g) for p, g in out.items()})
        return out

    pmesh.all_reduce_gradients = recording
    init, step = make_parallel_train_step(cfg, config_anchors(cfg), mesh)
    state = init(weights.to_device(weights.params_from_numpy(params_np, cfg),
                                   dev))
    out = []
    for b_s, d_s in zip(batches, draws):
        d = draws_from_numpy(d_s[mesh.data_index])
        state, metrics = step(state, port_batch(b_s[mesh.data_index]).to(dev),
                              tstep.TrainDraws(
                                  TargetDraws(*(u.to(dev) for u in d.targets)),
                                  None if d.dropout_masks is None else
                                  [m.to(dev) for m in d.dropout_masks]))
        out.append(({k: float(v) for k, v in metrics.items()},
                    digest(state.params)))
    pmesh.all_reduce_gradients = reduce
    return {"data_index": mesh.data_index, "space_index": mesh.space_index,
            "steps": out, "grads": summed, "k1_launches": k1.launches}


def synthetic_batch(cfg, seed):
    """A tiny batch (numpy, tests/torch_port_train.py's format) built as
    the feeder builds one at angle 0: nested class boxes in a noise image
    (tests/test_train_step.py:17-39), the GT box from them, RPN targets
    from ``build_rpn_targets`` at ``seed``."""
    from cfun_tpu_torch.data.feeder import np_mask_to_extended_bbox
    from cfun_tpu_torch.train.targets import build_rpn_targets

    d, h, w = cfg.image_shape
    rng = np.random.default_rng(seed)
    labels = np.zeros((d, h, w), np.int32)
    labels[8:24, 16:48, 16:48] = 1
    labels[10:20, 20:40, 20:40] = 2
    labels[12:16, 24:32, 24:32] = 3
    image = (rng.normal(size=(d, h, w)) + 2.0 * (labels > 0)).astype(
        np.float32)
    gt_box = np_mask_to_extended_bbox(labels)
    match, deltas = build_rpn_targets(config_anchors(cfg), gt_box, cfg,
                                      np.random.default_rng(seed))
    norm = np.array([d, h, w, d, h, w], np.float32)
    return dict(image=image, rpn_match=match, rpn_deltas=deltas,
                gt_box_norm=gt_box / norm, labels=labels)


def step_suite(mesh, cases):
    """Several ``run_steps`` cases in one launch: name -> (cfg, params,
    batches, draws, layout)."""
    return {name: run_steps(mesh, *case) for name, case in cases.items()}


def loaded_modules(mesh):
    """(this rank, the top-level modules it has imported)."""
    import sys

    return mesh.rank, sorted({m.split(".")[0] for m in sys.modules})
