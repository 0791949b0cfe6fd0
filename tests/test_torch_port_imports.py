"""The port stands alone: importing every module of cfun_tpu_torch pulls in
neither JAX nor any module of the JAX package.  A subprocess, because this
test process has imported JAX already (tests/conftest.py)."""

import ast
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
       "cfun_tpu_torch.ops.augment", "cfun_tpu_torch.data.batch",
       "cfun_tpu_torch.utils.logging",
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


_ROOFLINE_PROBE = r"""
import importlib, pkgutil, sys
import cfun_tpu_torch
names = {m.name for m in pkgutil.walk_packages(cfun_tpu_torch.__path__,
                                               "cfun_tpu_torch.")}
mod = importlib.import_module("cfun_tpu_torch.utils.roofline")
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "ml_dtypes", "cfun_tpu")
             or m.startswith(("jax.", "jaxlib.", "cfun_tpu.")))
print(mod.__name__ in names, sorted(mod.PEAKS), bad)
"""


def test_roofline_imports_alone_with_card_peaks_only():
    """``utils/roofline.py`` is found by the walk, imports neither JAX nor
    the JAX package, and its peak table and source name no TPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _ROOFLINE_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True ['cpu', 'h100_sxm'] []", proc.stdout
    with open(os.path.join(ROOT, "cfun_tpu_torch", "utils",
                           "roofline.py")) as f:
        source = f.read().lower()
    assert not re.search(r"\btpu\b|v5e|v5p|\bv4\b", source)


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


def _port_imports():
    """{module: {package module it imports}} over every ``.py`` under
    ``cfun_tpu_torch/`` (imports at any depth, each named by the deepest
    module it names), and the (module, line, target) of each import made
    inside a function body."""
    pkg = os.path.join(ROOT, "cfun_tpu_torch")
    paths = {}
    for d, dirs, names in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for n in names:
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, n), ROOT)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts.pop()
                paths[".".join(parts)] = os.path.join(d, n)

    def module_of(name):
        while name not in paths:
            name = name.rsplit(".", 1)[0]
        return name

    graph, deferred = {m: set() for m in paths}, set()

    def visit(mod, node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                targets = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom):
                assert child.level == 0, f"{mod}:{child.lineno} is relative"
                targets = [f"{child.module}.{a.name}" for a in child.names]
            else:
                targets = []
            for t in targets:
                if t.split(".")[0] == "cfun_tpu_torch":
                    graph[mod].add(module_of(t))
                    if in_function:
                        deferred.add((mod, child.lineno, module_of(t)))
            visit(mod, child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    for mod, path in paths.items():
        with open(path) as f:
            visit(mod, ast.parse(f.read()), False)
    return graph, deferred


def test_port_module_graph_points_one_way():
    """The port's modules import one another without a cycle, and at
    module top: a function imports a module of the package only in the
    CLIs (``cli/``) or to load the native build (``_build``)."""
    graph, deferred = _port_imports()
    assert len(graph) > 40
    state, cycles = {}, []

    def walk(mod, path):
        state[mod] = "open"
        for dep in sorted(graph[mod] - {mod}):
            if state.get(dep) == "open":
                cycles.append(path[path.index(dep):] + [dep])
            elif dep not in state:
                walk(dep, path + [dep])
        state[mod] = "done"

    for mod in sorted(graph):
        if mod not in state:
            walk(mod, [mod])
    assert cycles == []
    assert sorted((m, line, t) for m, line, t in deferred
                  if not m.startswith("cfun_tpu_torch.cli")
                  and t != "cfun_tpu_torch._build") == []
