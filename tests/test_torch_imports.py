"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, jaxlib or the JAX package (``repro``), and
``triton`` is never imported at module level (the CPU test machines have
none, and the tests import every module)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(tree):
    """(top-level module name, at module level?) of every import."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], id(node) in top


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = list(_imports(tree))
    bad = sorted({mod for mod, _ in found if mod in FORBIDDEN})
    assert not bad, f"{path.name} imports {bad}"
    assert ("triton", True) not in found, f"{path.name} imports triton at top"


def test_the_walk_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/fed/rounds.py" in names
    assert "src/repro_torch/kernels/ops.py" in names
    for module in ("configs/base.py", "configs/qwen2_5_3b.py",
                   "configs/glm4_9b.py", "configs/minitron_8b.py",
                   "models/layers.py", "models/transformer.py",
                   "launch/steps.py", "kernels/flash_attention.py"):
        assert f"src/repro_torch/{module}" in names
    assert len(names) >= 36
