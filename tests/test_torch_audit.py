"""repro_torch.audit against repro.audit: every rule fires on a seeded
violation with the reference's (rule, severity), the port's traces of the
real paths give the reference's cross-batch reduction counts and findings,
the CLI is clean on the repo, and the two packages read each other's
baselines.

Each seeded case builds the same hazard twice — a jaxpr for the reference's
rule, a recorded torch trace (or a torch-spelled source snippet) for the
port's — and holds the two findings' ``(rule, severity)`` multisets equal.
The reference's ``collect_traced`` and ``trace_pallas_kernels`` are not
run: under this tree's jax they raise (``pl.store`` is gone); its probes
are called one by one, as ``tests/test_audit.py`` does.
"""
import collections
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.audit import ast_rules as jast
from repro.audit import harness as jharness
from repro.audit import jaxpr_rules
from repro.audit import probe as jprobe
from repro.audit import reachability as jreach
from repro.audit.contracts import QuantContract as JQuantContract
from repro.audit.findings import Baseline as JBaseline
from repro.audit.findings import Finding as JFinding
from repro.core import engine as jengine
from repro_torch.audit import (ast_rules, cli, harness, probe, reachability,
                               smem, trace_rules)
from repro_torch.audit.contracts import (SMEM_BUDGET_BYTES, QuantContract,
                                         block_bytes)
from repro_torch.audit.findings import Baseline, BaselineError, Finding
from repro_torch.core import engine

ROOT = cli.repo_root()
B = probe.B_PROBE


def _multiset(findings):
    return collections.Counter((f.rule, f.severity) for f in findings)


def _jtrace(fn, *args):
    return jax.make_jaxpr(fn)(*args)


def _ttrace(fn, *args):
    return probe.record(ROOT, fn, *args)


# ---------------------------------------------------------------------------
# Trace layer: seeded violations, one hazard built in both packages
# ---------------------------------------------------------------------------

def _f64(pkg):
    if pkg == "jax":
        with jax.enable_x64(True):
            closed = _jtrace(lambda x: jnp.sin(x) * 2.0,
                             jnp.zeros((3,), jnp.float64))
        return jaxpr_rules.check_dtypes("fixture", closed, ROOT)
    return trace_rules.check_dtypes("fixture", _ttrace(
        lambda x: torch.sin(x) * 2.0, torch.zeros(3, dtype=torch.float64)),
        ROOT)


def _f32(pkg):
    if pkg == "jax":
        return jaxpr_rules.check_dtypes("fixture", _jtrace(
            lambda x: jnp.sin(x) * 2.0, jnp.zeros((3,), jnp.float32)), ROOT)
    return trace_rules.check_dtypes("fixture", _ttrace(
        lambda x: torch.sin(x) * 2.0, torch.zeros(3)), ROOT)


def _host_sync(pkg):
    if pkg == "jax":
        def f(x):
            y = jax.pure_callback(lambda v: np.asarray(v),
                                  jax.ShapeDtypeStruct((3,), jnp.float32), x)
            return y + 1.0

        return jaxpr_rules.check_host_sync("fixture", _jtrace(
            f, jnp.zeros((3,), jnp.float32)), ROOT)
    # a value pulled to the host inside the traced call, unmarked
    return trace_rules.check_host_sync("fixture", _ttrace(
        lambda x: x + x.sum().item(), torch.zeros(3)), ROOT)


def _purity(axis, declared):
    def case(pkg):
        if pkg == "jax":
            closed = _jtrace(lambda x: x.sum(axis=axis), jnp.zeros((B, 8)))
            return jaxpr_rules.check_batch_purity(
                "fixture", closed, frozenset({B}), declared, ROOT)
        trace = _ttrace(lambda x: x.sum(axis), torch.zeros(B, 8))
        return trace_rules.check_batch_purity(
            "fixture", trace, frozenset({B}), declared, ROOT)
    return case


def _quant(kind):
    """Four int8 paths: straight to float, an int8 accumulator, the
    contracted one (int32 accumulate, one dequant), no dequant at all."""
    def case(pkg):
        if pkg == "jax":
            f32, i8, i32 = jnp.float32, jnp.int8, jnp.int32
            a_q, b, b_q = (jnp.zeros((4, 6), i8), jnp.zeros((6, 2), f32),
                           jnp.zeros((6, 2), i8))
            scale = jnp.float32(1.0)
            cast = lambda x, dt: x.astype(dt)  # noqa: E731
            check = jaxpr_rules.check_quant
            tracer = _jtrace
            contract = JQuantContract()
        else:
            f32, i8, i32 = torch.float32, torch.int8, torch.int32
            a_q, b, b_q = (torch.zeros((4, 6), dtype=i8), torch.zeros(6, 2),
                           torch.zeros((6, 2), dtype=i8))
            scale = torch.ones(())
            cast = lambda x, dt: x.to(dt)  # noqa: E731
            check = trace_rules.check_quant
            tracer = _ttrace
            contract = QuantContract()
        fns = {
            "direct": (lambda a, w, s: (cast(a, f32) @ w) * s, (a_q, b, scale)),
            "int8-accum": (lambda a, w: a @ w, (a_q, b_q)),
            "contracted": (lambda a, w, s: cast(cast(a, i32) @ cast(w, i32),
                                                f32) * s, (a_q, b_q, scale)),
            "no-dequant": (lambda a, w: cast(a, i32) @ cast(w, i32),
                           (a_q, b_q)),
        }
        fn, args = fns[kind]
        closed = tracer(fn, *args)
        out = check("fixture", closed, contract, ROOT)
        if kind == "direct":
            out += (jaxpr_rules.check_no_int8_dequant("fixture", closed, ROOT)
                    if pkg == "jax" else
                    trace_rules.check_no_int8_dequant("fixture", closed,
                                                      ROOT))
        return out
    return case


TRACE_CASES = {
    "f64-promotion": _f64,
    "f32-quiet": _f32,
    "host-sync-in-trace": _host_sync,
    "batch-purity-undeclared": _purity(0, 0),
    "batch-purity-declared": _purity(0, 1),
    "batch-purity-stale": _purity(0, 2),
    "batch-purity-program-axis": _purity(1, 0),
    "quant-direct-int8-dequant": _quant("direct"),
    "quant-wrong-accumulator": _quant("int8-accum"),
    "quant-contracted-shape": _quant("contracted"),
    "quant-missing-dequant": _quant("no-dequant"),
}
TRACE_EXPECTED = {      # the reference's own verdicts, as test_audit.py has
    "f64-promotion": {("dtype-f64", "error"): 3},
    "f32-quiet": {},
    "host-sync-in-trace": {("host-sync", "error"): 1},
    "batch-purity-undeclared": {("batch-purity", "error"): 1},
    "batch-purity-declared": {},
    "batch-purity-stale": {("batch-purity", "warning"): 1},
    "batch-purity-program-axis": {},
    "quant-direct-int8-dequant": {("quant-accum", "error"): 2,
                                  ("quant-dequant", "error"): 1},
    "quant-wrong-accumulator": {("quant-accum", "error"): 2},
    "quant-contracted-shape": {},
    "quant-missing-dequant": {("quant-accum", "error"): 1},
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_seeded_trace_violation_matches_reference(case):
    ref = _multiset(TRACE_CASES[case]("jax"))
    port = _multiset(TRACE_CASES[case]("torch"))
    assert ref == TRACE_EXPECTED[case]
    assert port == ref


def test_batch_purity_anchor_points_at_the_reduction():
    trace = _ttrace(lambda x: x.sum(0), torch.zeros(B, 8))
    found = trace_rules.check_batch_purity("f", trace, frozenset({B}), 0,
                                           ROOT)
    assert found and "test_torch_audit" in found[0].file
    assert found[0].line > 0


def test_batch_purity_counts_a_flattened_batch_axis():
    """The port flattens the batch into composite axes (B*T rows,
    N*C_in*K2*words kept bits): an eliminated axis whose size 13 divides
    is batch-tainted, though it is neither 13 nor 52."""
    trace = _ttrace(lambda x: x.reshape(-1).sum(), torch.zeros(B, 8))
    found = trace_rules.check_batch_purity("f", trace, frozenset({B}), 0,
                                           ROOT)
    assert [(f.rule, f.severity) for f in found] == [("batch-purity",
                                                      "error")]


def test_batch_purity_counts_loss_reductions_in_both_spellings():
    """Under autograd cross_entropy dispatches log_softmax + nll_loss
    (reduction mean); under inference mode it is one cross_entropy_loss."""
    logits = torch.zeros(B, 6)
    labels = torch.zeros(B, dtype=torch.long)
    fn = torch.nn.functional.cross_entropy
    grad = _ttrace(fn, logits, labels)
    with torch.inference_mode():
        whole = _ttrace(fn, logits, labels)
    for trace in (grad, whole):
        assert len(trace_rules.batch_reductions(trace, {B})) == 1
    assert {r.packet for r in whole} >= {"cross_entropy_loss"}
    assert {r.packet for r in grad} >= {"nll_loss_forward"}
    none = _ttrace(lambda a, b: fn(a, b, reduction="none"), logits, labels)
    assert trace_rules.batch_reductions(none, {B}) == []


def _rec(op, ins, outs, line=0):
    meta = probe.TensorMeta
    return probe.OpRecord(op, tuple(meta(*m) for m in ins), {},
                          tuple(meta(*m) for m in outs), "-", line)


@pytest.mark.parametrize("rec,sync", [
    (_rec("_to_copy.default", [((3,), torch.float32, "cuda")],
          [((3,), torch.float32, "cpu")]), True),
    (_rec("_to_copy.default", [((3,), torch.float32, "cpu")],
          [((3,), torch.float32, "cuda")]), False),
    (_rec("nonzero.default", [((3,), torch.bool, "cuda")],
          [((3, 1), torch.int64, "cuda")]), True),
    (_rec("nonzero.default", [((3,), torch.bool, "cpu")],
          [((3, 1), torch.int64, "cpu")]), False),
    (_rec("_local_scalar_dense.default", [((), torch.int64, "cpu")], []),
     True),
    (_rec("item.default", [((), torch.int64, "cuda")], []), True),
], ids=["d2h-copy", "h2d-copy", "nonzero-card", "nonzero-cpu",
        "scalar-cpu", "item-card"])
def test_host_sync_kinds(rec, sync):
    found = trace_rules.check_host_sync("f", [rec], ROOT)
    assert bool(found) == sync


def test_gate_syncs_pass_only_marked_and_allowed():
    """queue_sparse's gate pulls two scalars at lines marked 'the
    occupancy gate': clean under its contract's 'occupancy-gate', an error
    under a contract that allows nothing."""
    gate = probe.trace_sparse_pieces(device="cpu")["engine._sparse_gate"]
    syncs = [r for r in gate if r.packet in ("item", "_local_scalar_dense")]
    assert len(syncs) == 2
    assert all(r.file == "src/repro_torch/core/engine.py" for r in syncs)
    allowed = engine.BACKEND_CONTRACTS["queue_sparse"].allowed_host_syncs
    assert trace_rules.check_host_sync("gate", gate, ROOT, allowed) == []
    assert len(trace_rules.check_host_sync("gate", gate, ROOT)) == 2
    assert len(trace_rules.check_host_sync(
        "gate", gate, ROOT, ("serve-block-until-ready",))) == 2


def test_kernel_launches_become_records(monkeypatch):
    """A ctypes launch dispatches nothing: the recorder adds one
    kernel:<name> record per launch counter step."""
    from repro_torch.kernels import _cuda

    def fake_launch(x):
        _cuda.launch_counts["fused_spike_accum"] += 1
        return x + 1

    monkeypatch.setitem(_cuda.launch_counts, "fused_spike_accum", 0)
    trace = _ttrace(fake_launch, torch.zeros(2))
    assert probe.launches(trace) == {"fused_spike_accum": 1}


def test_missing_backend_contract_is_a_finding():
    contract, missing = cli._contract(engine, "no_such_backend")
    assert contract is None
    assert (missing.rule, missing.severity) == ("contract", "error")


# ---------------------------------------------------------------------------
# AST layer: seeded violations, the reference's snippet beside torch's
# ---------------------------------------------------------------------------

AST_CASES = {   # name -> (jax source, torch source); line for line alike
    "f64": ("""
        import jax.numpy as jnp
        X = jnp.zeros((3,), jnp.float64)
        """, """
        import torch
        X = torch.zeros((3,), dtype=torch.float64)
        """),
    "np-in-jit": ("""
        import jax
        import numpy as np

        MEAN = np.mean([1, 2])          # host math outside jit: fine

        @jax.jit
        def traced(x):
            return x + np.float32(np.pi)  # host math inside jit: flagged
        """, """
        import torch
        import numpy as np

        MEAN = np.mean([1, 2])          # host math outside compile: fine

        @torch.compile
        def traced(x):
            return x + np.float32(np.pi)  # host math inside: flagged
        """),
    "vmap-over-queue": ("""
        import jax
        from repro.kernels.ops import fused_spike_accum

        def per_sample(occ, w):
            return jax.vmap(lambda o: fused_spike_accum(o[None], w))(occ)
        """, """
        import torch
        from repro_torch.kernels.ops import fused_spike_accum

        def per_sample(occ, w):
            return torch.vmap(lambda o: fused_spike_accum(o[None], w))(occ)
        """),
    "vmap-of-plain-fn": ("""
        import jax

        def batched(f, xs):
            return jax.vmap(f)(xs)
        """, """
        import torch

        def batched(f, xs):
            return torch.func.vmap(f)(xs)
        """),
    "banned-import": ("""
        from tests import conftest
        import benchmarks.memory_study
        """, """
        from tests import conftest
        import benchmarks.memory_study
        """),
    "host-sync-unmarked": ("""
        import jax

        def gate(total):
            return int(total.item())
        """, """
        import torch

        def gate(total):
            return int(total.item())
        """),
    "host-sync-marked-block": ("""
        import jax

        def gate(total):
            # audit: allow[host-sync] the occupancy gate: one scalar pull
            # per layer, by design (see docs/CONTRACTS.md)
            return int(jax.device_get(total))
        """, """
        import torch

        def gate(total):
            # audit: allow[host-sync] the occupancy gate: one scalar pull
            # per layer, by design
            return int(total.cpu().numpy())
        """),
    "obs-in-jit": ("""
        import jax
        from repro import obs

        obs.counter("host.side")         # outside jit: fine

        @jax.jit
        def traced(x):
            obs.counter("lies.once")     # fires at trace time only
            with obs.span("worse"):      # times the *trace*, not the run
                return x + 1
        """, """
        import torch
        from repro_torch import obs

        obs.counter("host.side")         # outside compile: fine

        @torch.compile(fullgraph=True)
        def traced(x):
            obs.counter("lies.once")     # fires at compile time only
            with obs.span("worse"):      # times the compile, not the run
                return x + 1
        """),
    "clock-in-jit": ("""
        import time
        import jax

        @jax.jit
        def traced(x):
            t0 = time.perf_counter()     # constant-folds to trace time
            return x * t0
        """, """
        import time
        import torch

        @torch.jit.script
        def traced(x):
            t0 = time.perf_counter()     # read at compile time
            return x * t0
        """),
    "clock-in-jit-marked": ("""
        import time
        import jax

        @jax.jit
        def traced(x):
            # audit: allow[host-sync] trying to talk my way past the rule
            t0 = time.perf_counter()
            return x * t0
        """, """
        import time
        import torch

        @torch.jit.trace
        def traced(x):
            # audit: allow[host-sync] trying to talk my way past the rule
            t0 = time.perf_counter()
            return x * t0
        """),
    "clock-unmarked": ("""
        import time

        def measure(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        """, None),
    "clock-marked": ("""
        import time

        def measure(fn):
            # audit: allow[host-sync] deliberate timing site
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0  # audit: allow[host-sync]
        """, None),
    "injectable-clock": ("""
        import time

        class Timed:
            def __init__(self, clock=time.perf_counter):
                self.clock = clock

            def now(self):
                return self.clock()
        """, None),
}


def _lint(tmp_path, module, source):
    p = tmp_path / "fixture_mod.py"
    p.write_text(textwrap.dedent(source))
    return module.check_file(str(p), str(tmp_path))


@pytest.mark.parametrize("case", sorted(AST_CASES))
def test_seeded_ast_violation_matches_reference(tmp_path, case):
    jsrc, tsrc = AST_CASES[case]
    ref = _lint(tmp_path, jast, jsrc)
    port = _lint(tmp_path, ast_rules, jsrc if tsrc is None else tsrc)
    assert sorted((f.rule, f.severity, f.line) for f in port) == \
        sorted((f.rule, f.severity, f.line) for f in ref)


@pytest.mark.parametrize("src,line", [
    ("import torch\nX = torch.zeros(3).double()\n", 2),
    ("import torch\nDT = torch.double\n", 2),
    ("import torch\nDT = torch.complex128\n", 2),
    ("import numpy as np\nDT = np.float64\n", 2),
], ids=["double-method", "torch-double", "complex128", "np-float64"])
def test_ast_f64_torch_spellings(tmp_path, src, line):
    found = _lint(tmp_path, ast_rules, src)
    assert [(f.rule, f.line) for f in found] == [("ast-f64", line)]


@pytest.mark.parametrize("call", [
    "x.cpu()", "x.tolist()", "x.numpy()", "x.item()",
    "torch.cuda.synchronize()", "stream.synchronize()",
    "event.synchronize()",
])
def test_host_sync_marker_torch_spellings(tmp_path, call):
    found = _lint(tmp_path, ast_rules, f"""
        import torch

        def pull(x, stream, event):
            return {call}
        """)
    assert [(f.rule, f.line) for f in found] == [("host-sync-marker", 5)]
    marked = _lint(tmp_path, ast_rules, f"""
        import torch

        def pull(x, stream, event):
            return {call}  # audit: allow[host-sync] a deliberate pull
        """)
    assert marked == []


def test_audit_package_excluded_from_self_lint(tmp_path):
    pkg = tmp_path / "audit"
    pkg.mkdir()
    (pkg / "rules.py").write_text("BANNED = 'float64'\n")
    (tmp_path / "lib.py").write_text("OK = 1\n")
    assert list(ast_rules.iter_source_files(str(tmp_path))) == \
        list(jast.iter_source_files(str(tmp_path))) == \
        [str(tmp_path / "lib.py")]


def test_dead_module_matches_reference(tmp_path):
    src = tmp_path / "src"
    pkg = src / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("from . import used\n")
    (pkg / "used.py").write_text("X = 1\n")
    (pkg / "orphan.py").write_text("Y = 2\n")
    (pkg / "cli.py").write_text('if __name__ == "__main__":\n    print(1)\n')
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_x.py").write_text("import pkg\n")
    port = reachability.check_reachability(str(tmp_path), str(src))
    ref = jreach.check_reachability(str(tmp_path), str(src))
    assert [(f.rule, f.severity, f.message) for f in port] == \
        [(f.rule, f.severity, f.message) for f in ref]
    assert "pkg.orphan" in port[0].message


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------

def test_smem_overflow_detected_at_absurd_geometry():
    """The reference's VMEM estimator flags the same absurd geometry."""
    from repro.audit import vmem
    from repro.audit.contracts import VMEM_BUDGET_BYTES

    geo = dict(K=3, n_win=342, depth=256, H=1024, W=1024, C_out=1024)
    assert vmem.kernel_footprint("repro.kernels.spike_pipeline",
                                 **geo) > VMEM_BUDGET_BYTES
    assert smem.kernel_footprint("repro_torch.kernels.spike_pipeline",
                                 **geo) > SMEM_BUDGET_BYTES


def test_smem_rule_fires_under_a_tiny_budget():
    found = smem.check_smem(ROOT, budget=1024)
    assert found and {(f.rule, f.severity) for f in found} == {
        ("smem-budget", "error")}
    # anchored at each kernel module's CONTRACT line, every module flagged
    assert all(f.file.startswith("src/repro_torch/kernels/") and f.line > 1
               for f in found)
    assert {f.file for f in found} == {
        f"src/repro_torch/kernels/{m}.py" for m in
        ("spike_pipeline", "spike_sparse", "event_accum", "spike_compact",
         "moe_gather")}


def test_smem_paper_geometries_fit_the_real_budget():
    assert smem.check_smem(ROOT) == []


def test_smem_one_budget_constant():
    from repro_torch.kernels import _cuda, spike_pipeline

    assert spike_pipeline._SMEM_MAX == SMEM_BUDGET_BYTES == 232_448
    assert f"-DREPRO_SMEM_MAX={SMEM_BUDGET_BYTES}" in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("K", [1, 3, 5, 7])
def test_smem_blocks_total_is_gather_smem(K):
    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import spike_pipeline as sp

    for hw in (8, 32, 128, 512):
        n_win = -(-hw // K)
        geo = dict(K=K, n_win=n_win, H=hw, W=hw)
        assert block_bytes(sp.smem_blocks(**geo)) == sp.gather_smem(**geo)
        assert block_bytes(ea.smem_blocks(cells=2, **geo)) == \
            sp.gather_smem(cells=2, **geo) <= sp.gather_smem(**geo)
    assert sp.smem_blocks(K=9, n_win=4, H=32, W=32) == []


# ---------------------------------------------------------------------------
# Recompilation harness
# ---------------------------------------------------------------------------

def test_second_pass_flat_on_real_engine_runner():
    cfg = probe.probe_config()
    plan = probe._plan(cfg)
    runner = engine.batch_runner(cfg, "dense")
    assert harness.second_pass_flat(
        runner, probe.probe_params(plan, "cpu"),
        probe.probe_thresholds(plan, "cpu"),
        probe.probe_images(cfg, 2, "cpu"))


def test_second_pass_flat_catches_growing_cache_like_reference():
    class Respecializing:
        """A runner whose 'cache' grows every call (the seeded hazard)."""

        def __init__(self):
            self.calls = 0

        def __call__(self, params, thresholds, images):
            self.calls += 1
            return jnp.zeros(()), None

        def _cache_size(self):
            return self.calls

    ref = jharness.second_pass_flat(Respecializing(), None, None, None)
    r = Respecializing()
    port = harness.second_pass_flat(r, None, None, None,
                                    misses=lambda: r.calls)
    assert ref is port is False


def test_recompilation_harness_clean_on_the_cpu():
    assert harness.check_recompilation(ROOT, "cpu") == []


# ---------------------------------------------------------------------------
# The real paths: the port's traces against the reference's
# ---------------------------------------------------------------------------

def _ref_hits(closed, tainted):
    """The reference rule's own hit count (``check_batch_purity``)."""
    return sum(1 for j in jaxpr_rules.all_jaxprs(closed) for eqn in j.eqns
               if any(s in tainted for s in
                      jaxpr_rules._eliminated_sizes(eqn)))


def _ref_findings(name, closed, declared, tainted, quant=False):
    if quant:
        return (jaxpr_rules.check_quant(name, closed, JQuantContract(), ROOT)
                + jaxpr_rules.check_dtypes(name, closed, ROOT))
    return (jaxpr_rules.check_dtypes(name, closed, ROOT)
            + jaxpr_rules.check_host_sync(name, closed, ROOT)
            + jaxpr_rules.check_batch_purity(name, closed, tainted, declared,
                                             ROOT)
            + jaxpr_rules.check_no_int8_dequant(name, closed, ROOT))


def _port_findings(name, trace, declared, tainted, quant=False, allowed=()):
    if quant:
        return (trace_rules.check_quant(name, trace, QuantContract(), ROOT)
                + trace_rules.check_dtypes(name, trace, ROOT))
    return (trace_rules.check_dtypes(name, trace, ROOT)
            + trace_rules.check_host_sync(name, trace, ROOT, allowed)
            + trace_rules.check_batch_purity(name, trace, tainted, declared,
                                             ROOT)
            + trace_rules.check_no_int8_dequant(name, trace, ROOT))


SPARSE_PIECES = {"engine._sparse_stats_fn": "engine._sparse_stats",
                 "engine._sparse_layer_fn": "engine._sparse_event_layer",
                 "engine._sparse_analog_fn": "engine._analog_layer"}


@pytest.fixture(scope="module")
def repo_traces():
    """Every traced path in both packages at the probe geometry:
    {name: (reference jaxpr, port trace, declared, quant?)}."""
    jcfg, cfg = jprobe.probe_config(), probe.probe_config()
    out = {}
    for name in jengine.available_backends():
        if name == "queue_sparse":
            continue
        out[f"backend:{name}"] = (jprobe.trace_backend(name, jcfg),
                                  probe.trace_backend(name, cfg, device="cpu"), 0,
                                  False)
    jp = jprobe.trace_sparse_pieces(jcfg)
    tp = probe.trace_sparse_pieces(cfg, device="cpu")
    declared = engine.BACKEND_CONTRACTS["queue_sparse"].cross_batch_reductions
    for jname, tname in SPARSE_PIECES.items():
        out[tname] = (jp[jname], tp[tname],
                      declared if jname.endswith("_stats_fn") else 0, False)
    jt = jprobe.trace_train_step(jcfg)
    tt = probe.trace_train_step(cfg, device="cpu")
    loss = "training.loss_fn[count+rate_reg]"
    out[loss] = (jt[loss], tt[loss],
                 engine.BACKEND_CONTRACTS["dense"].train_loss_reductions,
                 False)
    jq = jprobe.trace_quant_kernels()
    tq = probe.trace_quant_kernels(device="cpu")
    for name in jq:
        out[name] = (jq[name], tq[name], 0, True)
    return out


PATHS = ([f"backend:{n}" for n in ("dense", "dense_unrolled", "queue",
                                   "queue_pallas", "queue_ref")]
         + list(SPARSE_PIECES.values())
         + ["training.loss_fn[count+rate_reg]",
            "kernels.fused_spike_accum_sparse[q8]",
            "kernels.ref.fused_spike_accum_quant_ref",
            "kernels.ref.quant_matmul_ref", "engine._quant_head[q8]"])
EXPECTED_REDUCTIONS = {"engine._sparse_stats": 2,
                       "training.loss_fn[count+rate_reg]": 2}


@pytest.mark.parametrize("name", PATHS)
def test_repo_path_matches_reference(repo_traces, name):
    """Cross-batch reduction counts equal the reference's (0 in each traced
    backend and layer piece, 2 in the sparse stats and the training loss),
    and so do the findings: none, the quant traces included."""
    closed, trace, declared, quant = repo_traces[name]
    tainted = probe.batch_tainted_sizes(probe.probe_config())
    if not quant:
        want = EXPECTED_REDUCTIONS.get(name, 0)
        assert _ref_hits(closed, tainted) == want
        assert len(trace_rules.batch_reductions(trace, tainted)) == want
    ref = _ref_findings(name, closed, declared, tainted, quant)
    port = _port_findings(name, trace, declared, tainted, quant)
    assert _multiset(port) == _multiset(ref) == collections.Counter()


def test_repo_traces_record_the_engine_lines(repo_traces):
    """Anchors point into the port's modules, never the auditor."""
    _, trace, _, _ = repo_traces["engine._sparse_stats"]
    hits = trace_rules.batch_reductions(trace, {B})
    assert [h.file for h in hits] == ["src/repro_torch/core/engine.py"] * 2


def test_train_step_trace_under_declared_fires():
    """Declaring one loss reduction fewer fires batch-purity on the loss
    forward: the rule walks the surrogate dynamics; the full step (its
    backward contracts the batch into every weight gradient) keeps dtype
    and host-sync discipline."""
    traces = probe.trace_train_step(device="cpu")
    loss = traces["training.loss_fn[count+rate_reg]"]
    declared = engine.BACKEND_CONTRACTS["dense"].train_loss_reductions
    tainted = frozenset({B, B * probe.PROBE_T})
    under = trace_rules.check_batch_purity("loss", loss, tainted,
                                           declared - 1, ROOT)
    assert under and {(f.rule, f.severity) for f in under} == {
        ("batch-purity", "error")}
    step = traces["training.train_step"]
    assert trace_rules.check_dtypes("step", step, ROOT) == []
    assert trace_rules.check_host_sync("step", step, ROOT) == []


def test_kernel_traces_clean_on_the_cpu():
    for name, trace in probe.trace_kernels(device="cpu").items():
        assert trace_rules.check_dtypes(name, trace, ROOT) == [], name
        assert trace_rules.check_host_sync(name, trace, ROOT) == [], name


# ---------------------------------------------------------------------------
# The CLI and the repo
# ---------------------------------------------------------------------------

def test_static_layer_clean_on_repo():
    findings = cli.collect_static(ROOT)
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("argv", [["--no-trace", "--strict"],
                                  ["--strict", "--device", "cpu"]],
                         ids=["no-trace", "traced-cpu"])
def test_cli_strict_exits_zero(argv, capsys):
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "no findings outside the baseline" in out
    assert "Stale baseline entries" not in out


def test_cli_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--strict"])


def test_run_default_device_is_the_card(monkeypatch):
    """The library entry points run on the card unless asked for the CPU:
    ``cli.run`` without a device, with CUDA hidden, raises
    ``resolve_device``'s error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(ROOT, trace=True)
    plan = probe._plan(probe.probe_config())
    for call in (lambda: cli.collect_traced(ROOT),
                 lambda: harness.check_recompilation(ROOT),
                 lambda: probe.probe_params(plan),
                 lambda: probe.probe_thresholds(plan),
                 lambda: probe.probe_images(probe.probe_config()),
                 lambda: probe.trace_quant_kernels(),
                 lambda: probe.trace_kernels()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_committed_baseline_entries_are_justified():
    bl = Baseline.load(cli.DEFAULT_BASELINE)
    roadmap = open(f"{ROOT}/ROADMAP.md").read()
    for e in bl.entries:
        assert e["justification"].strip()
        assert e.get("device") in ("cpu", "cuda")
        assert e["message"].split(":")[0] in roadmap


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"findings": [
        {"rule": "r", "file": "f", "message": "m", "justification": ""}]}))
    assert cli.main(["--no-trace", "--baseline", str(bad)]) == 2


# ---------------------------------------------------------------------------
# Baselines, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_baseline_written_by_either_loads_in_the_other(tmp_path, writer):
    args = ("dead-module", "warning", "src/a.py", 1, "m1")
    other = ("dead-module", "warning", "src/b.py", 1, "m2")
    path = str(tmp_path / "baseline.json")
    W, F = (JBaseline, JFinding) if writer == "reference" else (Baseline,
                                                                Finding)
    W.from_findings([F(*args)], justification="known quirk").save(path)
    for R, G in ((JBaseline, JFinding), (Baseline, Finding)):
        bl = R.load(path)
        fresh, matched, stale = bl.split([G(*args), G(*other)])
        assert (fresh, matched, stale) == ([G(*other)], [G(*args)], [])
        # fingerprint is line-insensitive: a shifted line still matches
        assert G("dead-module", "warning", "src/a.py", 99, "m1") in bl


def test_baseline_device_entries_set_aside(tmp_path):
    f = Finding("quant-accum", "error", "-", 0, "m")
    bl = Baseline([{"rule": f.rule, "file": f.file, "message": f.message,
                    "justification": "card only", "device": "cuda"}])
    assert bl.split([f], "cuda") == ([], [f], [])
    assert bl.split([], "cpu") == ([], [], [])
    assert bl.split([f], "cpu") == ([f], [], [])
    assert len(bl.split([], "cuda")[2]) == 1


def test_baseline_requires_justification(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"findings": [
        {"rule": "r", "file": "f", "message": "m", "justification": "  "}]}))
    with pytest.raises(BaselineError, match="justification"):
        Baseline.load(str(path))


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError, match="severity"):
        Finding("r", "fatal", "f", 1, "m")
