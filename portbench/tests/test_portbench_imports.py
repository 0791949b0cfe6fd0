"""The import guard: nothing under portbench/ imports JAX or the JAX
package (top-level names compared whole: the port's ``cfun_tpu_torch``
begins with ``cfun_tpu``), the plain reference imports nothing of the
program, and nothing reads the JAX package's benchmark scripts."""

import ast
import os

import pytest

from portbench import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_READS = ("benchmarks/", "bench.py", "chip_smoke", "BENCH_r0")


def sources(sub=""):
    root = os.path.join(PKG, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def non_doc_strings(path):
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_and_no_jax_package(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "cfun_tpu"}, names


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_loaded(
        ["cfun_tpu_torch", "cfun_tpu_torch.models.cfun", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_loaded(
        ["cfun_tpu", "cfun_tpu.models", "jax.numpy", "jaxlib", "flax",
         "cfun_tpu_torch"]) == ["cfun_tpu", "cfun_tpu.models", "flax",
                                "jax.numpy", "jaxlib"]


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    assert "cfun_tpu_torch" not in set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_nothing_reads_the_jax_benchmarks(path):
    names = set(top_level_imports(path))
    assert not names & {"bench", "benchmarks", "chip_smoke"}
    if os.path.samefile(path, __file__):  # the list of what is not read
        return
    for s in non_doc_strings(path):
        assert not any(f in s for f in FORBIDDEN_READS), s
