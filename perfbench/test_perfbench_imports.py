"""Nothing under perfbench/ imports JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""

import ast
import os

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "nmc_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, (path, bad)


def test_the_reference_imports_only_torch_numpy_and_itself():
    for path in _sources("reference"):
        mods = set(_imports(path))
        assert mods <= {"torch", "numpy", "math", "typing", "__future__",
                        "dataclasses"}, (path, mods)


def test_the_name_guard_compares_whole_names():
    assert "nmc_tpu" in harness.FORBIDDEN
    assert "nmc_tpu_torch".split(".")[0] not in harness.FORBIDDEN
