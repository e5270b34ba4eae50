"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or the reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


# modules whose names the checks below must cover (the data-parallel
# layer, the resolver and the sweep runner, then the contract checker)
NAMED = ("parallel/__init__.py", "parallel/mesh.py", "parallel/executor.py",
         "sharding/__init__.py", "sharding/resolver.py", "study/sweep.py",
         "audit/__init__.py", "audit/__main__.py", "audit/ast_rules.py",
         "audit/cli.py", "audit/contracts.py", "audit/findings.py",
         "audit/gh_summary.py", "audit/harness.py", "audit/probe.py",
         "audit/reachability.py", "audit/smem.py", "audit/trace_rules.py")


def test_port_files_exist():
    assert len(PORT_FILES) > 20 and all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("name", NAMED)
def test_named_modules_are_checked(name):
    assert ROOT / "src" / "repro_torch" / name in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
