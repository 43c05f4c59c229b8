"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole, in the sources and in a process after a run."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from rtbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "mygpuraytracer_tpu"}


def sources(sub=""):
    root = os.path.join(core.ROOT, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, core.ROOT))
def test_no_jax_in_the_benchmark(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, core.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert not (FORBIDDEN | {"mygpuraytracer_tpu_torch", "rtbench"}) & names


def test_no_jax_loaded_after_a_run(in_repo):
    code = ("import sys; sys.path.insert(0, 'rtbench/tests'); from tiny import tiny_run; "
            "from rtbench import core; tiny_run('cornellShipTex.drag', res=8); "
            "tiny_run('cornell.converge', res=8); print(core.forbidden_modules(sys.modules))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=in_repo)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
