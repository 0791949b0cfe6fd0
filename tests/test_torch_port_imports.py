"""The port stands alone: importing every module of cfun_tpu_torch pulls in
neither JAX nor any module of the JAX package.  A subprocess, because this
test process has imported JAX already (tests/conftest.py)."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import cfun_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cfun_tpu_torch.__path__,
                                                "cfun_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "ml_dtypes", "cfun_tpu")
             or m.startswith(("jax.", "jaxlib.", "cfun_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_or_cfun_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20, proc.stdout
    assert bad == "[]", f"the port imported {bad}"


_TRAIN_PROBE = r"""
import importlib, pkgutil, sys
import cfun_tpu_torch
names = {m.name for m in pkgutil.walk_packages(cfun_tpu_torch.__path__,
                                               "cfun_tpu_torch.")}
new = ["cfun_tpu_torch.train", "cfun_tpu_torch.train.losses",
       "cfun_tpu_torch.train.targets", "cfun_tpu_torch.train.step",
       "cfun_tpu_torch.train.loop", "cfun_tpu_torch.data.feeder",
       "cfun_tpu_torch.ops.augment", "cfun_tpu_torch.utils.logging",
       "cfun_tpu_torch.utils.checkpoint", "cfun_tpu_torch.parallel",
       "cfun_tpu_torch.parallel.mesh", "cfun_tpu_torch.parallel.halo",
       "cfun_tpu_torch.parallel.launch"]
for name in new:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "ml_dtypes", "optax", "cfun_tpu")
             or m.startswith(("jax.", "jaxlib.", "optax.", "cfun_tpu.")))
print(sorted(set(new) - names), bad)
"""


def test_train_modules_import_alone():
    """The training modules (the step, the loop, the feeder, the device
    augment, the logs and checkpoints, the mesh, its halo exchanges and
    the launcher of its ranks) are found by the walk above and
    import neither JAX, optax, ml_dtypes nor the JAX package: the port
    keeps its own ``build_rpn_targets``, ``np_mask_to_extended_bbox``,
    ``rotate_hw`` and train molds."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []", proc.stdout


def test_spawned_rank_imports_no_jax():
    """A rank that ``parallel/launch.py`` spawns (from this process, which
    has imported JAX and the JAX package) starts from a fresh interpreter:
    it imports neither, with the port's mesh and step loaded."""
    from cfun_tpu_torch.parallel.launch import launch
    import torch_port_ranks

    ranks = launch(torch_port_ranks.loaded_modules, 2, 1, devices="cpu")
    assert [rank for rank, _ in ranks] == [0, 1]
    for rank, modules in ranks:
        assert {"torch", "cfun_tpu_torch", "torch_port_ranks"} <= set(
            modules)
        bad = {"jax", "jaxlib", "ml_dtypes", "optax", "cfun_tpu"} & set(
            modules)
        assert not bad, f"rank {rank} imported {sorted(bad)}"


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|ml_dtypes|optax|cfun_tpu(\.|\s|$))")
    files = [os.path.join(ROOT, name)
             for name in ("chip_smoke.py", "k1_compare.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "cfun_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.match(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert len(files) > 20 and offenders == []


def test_port_sources_name_no_native_dir():
    """The port builds its own host ops (``cfun_tpu_torch/csrc/
    host_ops.cc``) and names no file of the JAX package's ``native/``."""
    pattern = re.compile(r"(?<![\w.-])native/")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "cfun_tpu_torch")):
        if os.path.basename(d) == "_build":
            continue
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cc", ".cu"))]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert any(p.endswith("host_ops.cc") for p in files)
    assert offenders == []
