"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole
(the port's name begins with the JAX package's)."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def relative_targets(path: Path) -> set[Path]:
    """Directories that the file's relative imports reach."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = path.parent
            for _ in range(node.level - 1):
                base = base.parent
            out.add(base)
    return out


MODULES = sorted(BENCH.rglob("*.py"))


def test_every_module_is_walked():
    assert BENCH / "run.py" in MODULES
    assert BENCH / "reference" / "snn.py" in MODULES
    # the runners, which a configuration names
    assert BENCH / "runners" / "snn.py" in MODULES
    assert any(p.parent.name == "metrics" for p in MODULES)


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "bench" not in top_level_imports(path)
    for target in relative_targets(path):
        assert target == BENCH / "reference"


def test_names_are_compared_whole(monkeypatch):
    from bench.harness import cell

    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert {"jax", "repro"} <= set(cell.forbidden_modules())


def test_the_program_loads_no_jax():
    """What the harness imports of the port, in a fresh process."""
    import subprocess

    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from bench.harness import cell, manifest, serve, profile; "
            "manifest.runner('snn'); "
            "import repro_torch.serve, repro_torch.parallel, repro_torch.obs; "
            "print(cell.forbidden_modules())"
            % (str(BENCH.parent), str(BENCH.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
