"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast

import pytest

from benchmark.harness.bench import FORBIDDEN, forbidden_modules
from benchmark.harness.spec import BENCH_DIR

PORT = "exemplars_vc_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
    return tops


FILES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not imported_tops(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in imported_tops(path)
    assert "benchmark.harness" not in path.read_text()


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "exemplars_vc_tpu_torch_probe", types.ModuleType("x"))
    assert "exemplars_vc_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "exemplars_vc_tpu.config", types.ModuleType("y"))
    assert "exemplars_vc_tpu" in forbidden_modules()
