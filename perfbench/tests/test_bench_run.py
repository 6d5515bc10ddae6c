"""run.py refuses to run without a card, and nothing the benchmark runs on
the card imports JAX or the JAX package; the reference imports nothing of
the program either."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from perfbench.lib.manifest import ROOT
from perfbench.lib.runner import forbidden_modules

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "smollm-360m.train-32x2048", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models.lm",
                              "jaxtyping", "reprox", "torch"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "repro", "repro.models"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.models"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        assert not JAX_NAMES & set(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "perfbench" / "ref").glob("*.py")):
        names = set(_imports(path))
        assert not (JAX_NAMES | {"repro_torch", "perfbench"}) & names, path
