"""The port's import graph around its eigensolvers: `ops/eigh64.py` owns
the choice of eigensolver, so the kernel modules below it are leaves and
nothing under `ops/` reaches up into the layers that call it."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "multioptpy_tpu_torch"
NAME = "multioptpy_tpu_torch"


def _imports(path):
    """Every module a file imports, at any depth of its code (lazy imports
    included): `from a import b` names both a and a.b."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{alias.name}" for alias in node.names)
    return out


def _reaches(imports, package):
    return sorted(m for m in imports
                  if m == package or m.startswith(package + "."))


@pytest.mark.parametrize("path", sorted((PKG / "ops").glob("*.py")),
                         ids=lambda p: p.name)
def test_ops_import_no_upper_layer(path):
    imports = _imports(path)
    for layer in ("steppers", "calculators", "drivers"):
        assert not _reaches(imports, f"{NAME}.{layer}"), (path.name, layer)


@pytest.mark.parametrize("kernel, other", [("jacobi_cuda", "tridiag_cuda"),
                                           ("tridiag_cuda", "jacobi_cuda")])
def test_kernel_modules_are_leaves(kernel, other):
    imports = _imports(PKG / "ops" / f"{kernel}.py")
    for module in ("eigh64", other):
        assert not _reaches(imports, f"{NAME}.ops.{module}"), module


def test_the_calculator_imports_no_step_engine():
    imports = _imports(PKG / "calculators" / "sqm.py")
    assert not _reaches(imports, f"{NAME}.steppers")
