"""Nothing of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program."""
import ast
import sys

import pytest

from portbench import spec
from portbench.run import forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "photon_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in spec.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((spec.HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"photon_tpu_torch",
                                                   "portbench"})


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "photon_tpu_torch_fake", object())
    assert "photon_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "photon_tpu.fake", object())
    assert "photon_tpu" in forbidden_modules()
