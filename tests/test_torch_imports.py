"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or the reference package ``repro``. And it
is complete: every public top-level name the JAX package defines has its
counterpart in the port, under the same name or through the explicit
rename map below."""
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
         "audit/reachability.py", "audit/smem.py", "audit/trace_rules.py",
         "models/__init__.py", "models/layers.py", "models/ffn.py",
         "models/attention.py", "models/moe.py", "models/ssm.py",
         "models/xlstm.py", "models/transformer.py", "models/model.py",
         "training/grad_compress.py", "training/train_loop.py",
         "data/pipeline.py", "runtime/__init__.py",
         "runtime/fault_tolerance.py", "launch/__init__.py",
         "launch/mesh.py", "launch/costs.py", "launch/dryrun.py",
         "configs.py")


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


# ---------------------------------------------------------------------------
# Completeness: every public top-level name of src/repro/ has a counterpart
# ---------------------------------------------------------------------------

REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
# reference module -> the port's module of the same role
MODULE_RENAMES = {"audit/vmem.py": "audit/smem.py",          # VMEM -> SMEM
                  "audit/jaxpr_rules.py": "audit/trace_rules.py",
                  "configs/__init__.py": "configs.py"}
# (reference module, name) -> (port module, name): the same role renamed
NAME_RENAMES = {
    ("audit/contracts.py", "VMEM_BUDGET_BYTES"):
        ("audit/contracts.py", "SMEM_BUDGET_BYTES"),
    ("audit/vmem.py", "check_vmem"): ("audit/smem.py", "check_smem"),
    ("audit/vmem.py", "estimate_bytes"): ("audit/contracts.py",
                                          "block_bytes"),
    ("audit/probe.py", "trace_pallas_kernels"): ("audit/probe.py",
                                                 "trace_kernels"),
    ("audit/jaxpr_rules.py", "all_jaxprs"): ("audit/probe.py", "record"),
    ("audit/jaxpr_rules.py", "eqn_anchor"): ("audit/probe.py", "_anchor"),
    ("kernels/ops.py", "dispatch_counts"): ("kernels/_cuda.py",
                                            "launch_counts"),
    ("kernels/spike_pipeline.py", "fused_spike_accum_pallas"):
        ("kernels/spike_pipeline.py", "fused_spike_accum_cuda"),
    ("kernels/spike_pipeline.py", "fused_spike_accum_xla"):
        ("kernels/spike_pipeline.py", "fused_spike_accum_plain"),
    ("kernels/spike_pipeline.py", "vmem_blocks"):
        ("kernels/spike_pipeline.py", "smem_blocks"),
    ("kernels/spike_sparse.py", "fused_spike_accum_sparse_pallas"):
        ("kernels/spike_sparse.py", "fused_spike_accum_sparse_cuda"),
    ("kernels/spike_sparse.py", "fused_spike_accum_sparse"):
        ("kernels/spike_sparse.py", "fused_spike_accum_sparse_plain"),
    ("kernels/spike_sparse.py", "vmem_blocks"):
        ("kernels/spike_sparse.py", "smem_blocks"),
    ("kernels/event_accum.py", "event_accum"):
        ("kernels/event_accum.py", "event_accum_cuda"),
    ("kernels/event_accum.py", "vmem_blocks"):
        ("kernels/event_accum.py", "smem_blocks"),
    ("kernels/spike_compact.py", "spike_compact"):
        ("kernels/spike_compact.py", "spike_compact_cuda"),
    ("kernels/quant_matmul.py", "quant_matmul"):
        ("kernels/quant_matmul.py", "quant_matmul_cuda"),
    ("kernels/moe_gather.py", "moe_gather"):
        ("kernels/moe_gather.py", "moe_gather_cuda"),
    ("launch/dryrun.py", "ICI_BW"): ("launch/dryrun.py", "COLL_BW"),
}
# Pallas-only names: the choice between a Pallas kernel, its interpreter
# and XLA, which the port makes by the tensor's device instead
# (``kernels/ops.py`` dispatches a CUDA tensor to the kernel's wrapper,
# any other to its plain version)
PALLAS_ONLY = {
    ("kernels/ops.py", "default_spike_impl"),
    ("kernels/ops.py", "default_sparse_impl"),
    ("kernels/ops.py", "default_quant_impl"),
}


def _bound(path: Path) -> set:
    """Every name a module binds at top level: functions, classes,
    assignments and imports."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _defined(path: Path) -> set:
    """The public names a module defines (not those it imports)."""
    imported = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0]
                            for a in node.names)
    return {n for n in _bound(path) - imported if not n.startswith("_")}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_reference_name_has_a_counterpart(module):
    port_mod = PORT / MODULE_RENAMES.get(module, module)
    assert port_mod.exists(), f"no port of src/repro/{module}"
    have = _bound(port_mod)
    missing = []
    for name in sorted(_defined(REF / module)):
        if (module, name) in PALLAS_ONLY:
            assert name not in have, (module, name)
            continue
        target = NAME_RENAMES.get((module, name))
        if target is not None:
            if target[1] not in _bound(PORT / target[0]):
                missing.append(f"{name} -> {target[0]}:{target[1]}")
            continue
        if name not in have:
            missing.append(name)
    assert not missing, f"src/repro/{module}: no counterpart of {missing}"


def test_rename_maps_name_reference_names():
    for module, name in list(NAME_RENAMES) + sorted(PALLAS_ONLY):
        assert name in _defined(REF / module), (module, name)
    for module in MODULE_RENAMES:
        assert (REF / module).exists() and module in REF_MODULES
