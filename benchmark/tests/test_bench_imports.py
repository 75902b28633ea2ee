"""The run-time check of loaded modules compares whole top-level names."""
import sys
import types

from benchmark import harness


def test_rejects_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "pose6d_tpu.api",
                        types.ModuleType("pose6d_tpu.api"))
    assert harness.forbidden_modules() == ["pose6d_tpu"]


def test_rejects_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert "jaxlib" in harness.forbidden_modules()


def test_accepts_port(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import pose6d_tpu_torch.api  # noqa: F401
    monkeypatch.setitem(sys.modules, "pose6d_tpu_torch_extra",
                        types.ModuleType("pose6d_tpu_torch_extra"))
    assert harness.forbidden_modules() == []


def test_reference_imports_no_program():
    import ast
    from pathlib import Path
    ref = Path(harness.HERE) / "reference"
    for f in list(ref.glob("*.py")) + list((harness.HERE / "inputs")
                                           .glob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("pose6d_tpu_torch",
                                               *harness.FORBIDDEN), (f, n)
