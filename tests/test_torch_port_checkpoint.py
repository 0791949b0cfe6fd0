"""Checkpoints that both packages read, on the CPU: the port's
``utils/checkpoint.py`` (``save``, ``save_async``, ``flush``, ``load`` with
the optimizer slot) against the JAX package's ``cfun_tpu/utils/
checkpoint.py``.

Two cases, each one train step taken by both packages from the same
weights, batch and draws (tests/torch_port_train.py): the tiny heart
config at 'beginning' (everything trains) and a tiny LiTS config at
'together' (the trunk, RPN and classifier frozen).  Then each package
writes its checkpoint, and:

* the port's round trip gives back its parameters and optimizer leaves
  bit for bit;
* the JAX package loads the port's file with its own optimizer template
  (its ``load`` drops an ``opt/`` slot whose leaf count differs, so the
  count is checked first): the parameters are ``params_to_numpy`` of the
  port's, the traces the port's momentum buffers, zeros on frozen leaves;
* the port loads the JAX package's file: its parameters, and its traces
  as the momentum buffers of the trainable leaves (the frozen leaves'
  ``wd * p`` traces are dropped);
* one more step from each side's checkpoint in each package agrees to
  the step tests' parameter tolerance carried over two steps: one step's
  1e-6 (``lr`` times a trace's error) enters the second update 1.9 times
  through the momentum, plus the second gradient's, so 3e-6; and the
  frozen leaves do not move.

Also ``grad_accum_steps=2`` mid-accumulation (``MultiSteps``' counters and
accumulator both ways) and ``save_async`` + ``flush`` surfacing a writer
error.  The JAX optimizer's leaf order is pinned against
``jax.tree_util.tree_leaves`` of its state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu.train.step import TrainState as JaxState
from cfun_tpu.train.step import make_optimizer as jax_make_optimizer
from cfun_tpu.train.step import make_train_step as jax_make_train_step
from cfun_tpu.utils import checkpoint as jcheckpoint
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.train import step as tstep
from cfun_tpu_torch.utils import checkpoint as pcheckpoint
from torch_port_params import jax_params
import torch_port_train as T

TWO_STEP_ATOL = 3e-6
DETECTION = ("backbone", "fpn", "rpn", "classifier")


def _cfgs(case, **extra):
    ov = dict(nms_backend="scan", approx_topk=False, **extra)
    if case == "heart":
        return (jconfig.tiny_config(**ov), pconfig.tiny_config(**ov))
    lits = dict(name="lits", num_classes=3, backbone="P3D35",
                backbone_stem_kernel=(5, 7, 7), intensity_norm="hu_window",
                pad_shape=(64, 128, 128), mask_class_weights=(1.0, 1.0, 100.0),
                unet_dropout_rate=0.0, mask_pool_size=(16, 16, 16),
                mask_shape_override=(16, 16, 16), **ov)
    return (jconfig.tiny_config("together", **lits),
            pconfig.tiny_config("together", **lits))


def _port_state(pcfg, anchors, params_np):
    init, step = tstep.make_train_step(pcfg, anchors)
    return init(weights.params_from_numpy(params_np, pcfg)), step


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module", params=["heart", "lits_together"])
def case(request, tmp_path_factory):
    """Both packages one step from the same start; both checkpoints."""
    jcfg, pcfg = _cfgs(request.param.split("_")[0])
    anchors = config_anchors(jcfg)
    jp = jax_params(jcfg, 1)
    tp = weights.params_from_numpy(jp, pcfg)
    batches = [T.organ_batch(pcfg, tp, s, pick=p)
               for s, p in ((1, 0), (4, 1))]
    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    jinit, jstep = jax_make_train_step(jcfg, anchors)
    js, _ = jstep(jinit(jax.tree.map(jnp.asarray, jp)),
                  T.jax_batch(batches[0]), keys[0])
    js = jax.tree.map(np.asarray, js)
    ps, pstep = _port_state(pcfg, anchors, jp)
    ps, _ = pstep(ps, T.port_batch(batches[0]),
                  T.jax_draws(keys[0], jcfg, pcfg))
    root = tmp_path_factory.mktemp(request.param)
    jpath, ppath = str(root / "jax.npz"), str(root / "port.npz")
    jcheckpoint.save(jpath, js.params, epoch=1, step=1,
                     opt_state=js.opt_state, meta={"stage": pcfg.stage})
    assert pcheckpoint.save(ppath[:-4], ps.params, epoch=1, step=1,
                            opt_state=ps.opt_state,
                            meta={"stage": pcfg.stage}) == ppath
    return dict(jcfg=jcfg, pcfg=pcfg, anchors=anchors, jp=jp, js=js, ps=ps,
                jstep=jstep, jinit=jinit, batches=batches, keys=keys,
                jpath=jpath, ppath=ppath)


def _frozen(path, pcfg):
    if path.endswith(("/mean", "/var")):
        return True
    return pcfg.name == "lits" and path.split("/")[0] in DETECTION


def test_leaf_order_is_jax_tree_leaves(case):
    """The port's ``opt/{i}`` order is the JAX optimizer state's
    ``tree_leaves`` order: the momentum trace of every parameter in the
    JAX tree's order."""
    jstate = jax_make_optimizer(case["jcfg"], case["jp"]).init(case["jp"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jstate)[0]]
    order = case["ps"].opt_state.tree_paths
    assert len(paths) == len(order)
    for p, q in zip(paths, order):
        assert p.endswith("".join(f"[{k}]" if k.isdigit() else f"['{k}']"
                                  for k in q.split("/"))), (p, q)


def test_port_round_trip(case):
    pcfg = case["pcfg"]
    fresh, _ = _port_state(pcfg, case["anchors"], jax_params(case["jcfg"], 9))
    params, opt, meta = pcheckpoint.load(case["ppath"], fresh.params,
                                         fresh.opt_state)
    assert opt is fresh.opt_state
    assert (meta["epoch"], meta["step"], meta["stage"]) == (1, 1, pcfg.stage)
    for k, v in weights._leaves(case["ps"].params).items():
        assert torch.equal(weights._leaves(params)[k], v), k
    for a, b in zip(opt.state_leaves(), case["ps"].opt_state.state_leaves()):
        np.testing.assert_array_equal(a, b)


def test_jax_loads_port_checkpoint(case):
    pcfg, ps = case["pcfg"], case["ps"]
    template = jax_make_optimizer(case["jcfg"], case["jp"]).init(case["jp"])
    with np.load(case["ppath"]) as data:
        n_opt = sum(k.startswith("opt/") for k in data.files)
    assert n_opt == len(jax.tree_util.tree_leaves(template))
    params, opt, meta = jcheckpoint.load(case["ppath"], case["jp"], template)
    assert meta["step"] == 1
    want = T.flat_numpy(weights.params_to_numpy(ps.params))
    for k, v in T.flat_numpy(params).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    traces = dict(zip(ps.opt_state.tree_paths, _jax_leaves(opt)))
    jtraces = dict(zip(ps.opt_state.tree_paths,
                       _jax_leaves(case["js"].opt_state)))
    buffers = {p: ps.opt_state.sgd.state[leaf]["momentum_buffer"]
               for p, leaf in zip(ps.opt_state.paths, ps.opt_state.leaves)}
    for p, t in traces.items():
        if p in buffers:
            np.testing.assert_array_equal(
                t, weights._to_jax_layout(p, buffers[p]), err_msg=p)
            # and close to the JAX step's own trace (its gradient + decay)
            T.assert_grad_close(t, jtraces[p], p)
        else:
            assert _frozen(p, pcfg) and not t.any(), p


def test_port_loads_jax_checkpoint(case):
    pcfg, js = case["pcfg"], case["js"]
    fresh, _ = _port_state(pcfg, case["anchors"], case["jp"])
    params, opt, meta = pcheckpoint.load_any(case["jpath"], pcfg,
                                             fresh.params, fresh.opt_state)
    assert (meta["epoch"], meta["step"]) == (1, 1)
    want = T.flat_numpy(js.params)
    got = T.flat_numpy(weights.params_to_numpy(params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtraces = dict(zip(opt.tree_paths, _jax_leaves(js.opt_state)))
    for p, leaf in zip(opt.paths, opt.leaves):
        np.testing.assert_array_equal(
            weights._to_jax_layout(p, opt.sgd.state[leaf]["momentum_buffer"]),
            jtraces[p], err_msg=p)
    dropped = [p for p in opt.tree_paths if p not in opt.paths]
    assert all(_frozen(p, pcfg) for p in dropped)
    if pcfg.name == "lits":  # the JAX traces of frozen leaves: wd * p sums
        assert any(jtraces[p].any() for p in dropped)


def _port_resume(case, path):
    """The port from ``path`` (its parameters copied into a live state),
    one step on the second batch."""
    pcfg = case["pcfg"]
    state, step = _port_state(pcfg, case["anchors"], case["jp"])
    params, _, meta = pcheckpoint.load(path, state.params, state.opt_state)
    loaded = weights._leaves(params)
    with torch.no_grad():
        for k, leaf in weights._leaves(state.params).items():
            leaf.copy_(loaded[k])
    state = state._replace(step=meta["step"])
    before = {k: v.clone() for k, v in weights._leaves(state.params).items()}
    state, _ = step(state, T.port_batch(case["batches"][1]),
                    T.jax_draws(case["keys"][1], case["jcfg"], pcfg))
    for k, v in weights._leaves(state.params).items():
        if _frozen(k, pcfg):
            assert torch.equal(v, before[k]), k
    return T.flat_numpy(weights.params_to_numpy(state.params))


def _jax_resume(case, path):
    template = case["jinit"](jax.tree.map(jnp.asarray, case["jp"]))
    params, opt, meta = jcheckpoint.load(path, jax.tree.map(
        np.asarray, template.params), jax.tree.map(np.asarray,
                                                   template.opt_state))
    state = JaxState(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, opt),
                     jnp.asarray(meta["step"], jnp.int32))
    state, _ = case["jstep"](state, T.jax_batch(case["batches"][1]),
                             case["keys"][1])
    return T.flat_numpy(jax.tree.map(np.asarray, state.params))


def test_resume_across_packages_agrees(case):
    """One more step from each side's checkpoint in each package."""
    runs = {f"{who} from {src}": fn(case, case[f"{src}path"])
            for who, fn in (("port", _port_resume), ("jax", _jax_resume))
            for src in ("j", "p")}
    ref = runs["jax from j"]
    moved = 0
    for name, flat in runs.items():
        for k in ref:
            np.testing.assert_allclose(flat[k], ref[k], rtol=0,
                                       atol=TWO_STEP_ATOL,
                                       err_msg=f"{name}: {k}")
    for k in ref:
        moved += not np.array_equal(ref[k], T.flat_numpy(case["js"].params)[k])
    assert moved > 0


def test_grad_accum_mid_accumulation_both_ways(tmp_path):
    """``grad_accum_steps=2`` after one micro-step: the port writes
    ``MultiSteps``' counters (mini_step 1, gradient_step 0), the zero
    traces and its accumulator, which the JAX package's template takes;
    a JAX state with an accumulator loads into the port; and the port
    resumed from its own file takes the second micro-step to the
    parameters of the uninterrupted run, bit for bit."""
    jcfg, pcfg = _cfgs("heart", grad_accum_steps=2)
    anchors = config_anchors(jcfg)
    jp = jax_params(jcfg, 2)
    b = [T.port_batch(T.organ_batch(pcfg, weights.params_from_numpy(jp, pcfg),
                                    s)) for s in (0, 3)]
    draws = [tstep.draw_train(pcfg, torch.Generator().manual_seed(s), "cpu")
             for s in (11, 12)]
    state, step = _port_state(pcfg, anchors, jp)
    state, _ = step(state, b[0], draws[0])
    chain = state.opt_state
    assert chain.mini_step == 1 and chain.acc is not None
    path = str(tmp_path / "mid.npz")
    pcheckpoint.save(path, state.params, epoch=0, step=1, opt_state=chain)

    template = jax_make_optimizer(jcfg, jp).init(jp)
    _, opt, _ = jcheckpoint.load(path, jp, template)
    assert opt is not template  # the slot's leaf count matched
    assert int(opt.mini_step) == 1 and int(opt.gradient_step) == 0
    acc = dict(zip(chain.tree_paths, _jax_leaves(opt.acc_grads)))
    for p, a in zip(chain.paths, chain.acc):
        np.testing.assert_array_equal(acc[p], weights._to_jax_layout(p, a))
    assert not any(x.any() for x in _jax_leaves(opt.inner_opt_state))

    # a JAX state mid-accumulation into the port
    jstate = opt._replace(acc_grads=jax.tree.map(
        lambda x: np.full_like(x, 0.5), opt.acc_grads))
    jpath = str(tmp_path / "jax_mid.npz")
    jcheckpoint.save(jpath, jp, opt_state=jstate)
    fresh, _ = _port_state(pcfg, anchors, jp)
    _, popt, _ = pcheckpoint.load(jpath, fresh.params, fresh.opt_state)
    assert popt.mini_step == 1 and popt.gradient_step == 0
    assert all(torch.all(a == 0.5) for a in popt.acc)

    # resume from the port's own file: the second micro-step lands where
    # the uninterrupted run's does
    full, _ = step(state, b[1], draws[1])
    resumed, rstep = _port_state(pcfg, anchors, jp)
    params, _, _ = pcheckpoint.load(path, resumed.params, resumed.opt_state)
    with torch.no_grad():
        for k, leaf in weights._leaves(resumed.params).items():
            leaf.copy_(weights._leaves(params)[k])
    resumed, _ = rstep(resumed, b[1], draws[1])
    assert resumed.opt_state.gradient_step == 1
    for k, v in weights._leaves(full.params).items():
        assert torch.equal(weights._leaves(resumed.params)[k], v), k


def test_save_async_then_flush(tmp_path, monkeypatch):
    pcfg = pconfig.tiny_config()
    state, _ = _port_state(pcfg, config_anchors(pcfg),
                           jax_params(jconfig.tiny_config(), 3))
    path = str(tmp_path / "async")
    pcheckpoint.save_async(path, state.params, epoch=2, step=9,
                           opt_state=state.opt_state, meta={"loss": 1.5})
    pcheckpoint.flush()
    params, _, meta = pcheckpoint.load(path, weights.init_params(pcfg, 0))
    assert meta == {"epoch": 2, "step": 9, "loss": 1.5}
    for k, v in weights._leaves(state.params).items():
        assert torch.equal(weights._leaves(params)[k], v.detach()), k

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(pcheckpoint, "_write", broken)
    pcheckpoint.save_async(path, state.params)
    pcheckpoint.save_async(path, state.params)
    with pytest.raises(OSError, match="disk full"):
        pcheckpoint.flush()
    assert pcheckpoint._PENDING == []
    pcheckpoint.save_async(path, state.params)
    pcheckpoint.flush(raise_errors=False)  # printed, not raised
