"""No zkbench module imports JAX or the JAX package (top-level names
compared whole: zkfl_tpu_torch is another name), and the plain reference
imports nothing of the port."""

import ast
from pathlib import Path

import pytest

ZK = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in ZK.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "zkfl_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=[p.relative_to(ZK).as_posix() for p in MODULES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ZK / "plain").glob("*.py")),
                         ids=lambda p: p.name)
def test_plain_reference_imports_only_the_standard_library(path):
    imported = top_level_imports(path)
    assert "zkfl_tpu_torch" not in imported and "torch" not in imported
    assert "zkfl_tpu_torch" not in path.read_text()


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom zkfl_tpu.fl import x\nimport zkfl_tpu_torch\n")
    assert top_level_imports(bad) == {"jax", "zkfl_tpu", "zkfl_tpu_torch"}
