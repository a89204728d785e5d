"""No module of a run imports JAX or the JAX package, compared by the
whole top-level name; the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pcgcv2_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not {_top(m) for m in _imports(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    tops = {_top(m) for m in _imports(path)}
    assert "pcgcv2_torch" not in tops
    assert not tops & FORBIDDEN


def test_whole_name_compared():
    from h100bench.run import forbidden_modules
    import sys

    sys.modules.setdefault("pcgcv2_tpuX", sys)  # a longer name is not it
    try:
        assert "pcgcv2_tpuX" not in forbidden_modules()
    finally:
        del sys.modules["pcgcv2_tpuX"]
