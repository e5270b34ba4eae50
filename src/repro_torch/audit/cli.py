"""``python -m repro_torch.audit`` — run every contract rule, report, gate
(port of ``repro.audit.cli``; the exit codes are the reference's).

Exit status:

- default: nonzero iff any **error**-severity finding is not in the
  committed baseline;
- ``--strict`` (the CI gate): nonzero iff any error *or warning* is not in
  the baseline — i.e. the baseline is the complete set of accepted
  findings, and anything new fails the job. Info-severity notes never gate;
- 2: a malformed baseline.

The traced layer runs on ``--device`` (default ``cuda``, which raises
without a card, as every entry point of the port does; pass ``--device
cpu`` to trace on the CPU). ``--no-trace`` runs the AST layer alone and
touches no device. ``--write-baseline`` rewrites the baseline from the
current warnings (errors are never written — fix them, or add them by
hand with a justification); entries that name another device are kept.
"""
from __future__ import annotations

import argparse
import json
import os

from . import ast_rules, gh_summary, reachability
from .findings import Baseline, BaselineError, Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def repo_root() -> str:
    # audit/cli.py -> audit -> repro_torch -> src -> repo root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def collect_static(root: str) -> list[Finding]:
    """The pure-AST layer: the port's lint + reachability over ``src/``
    (no torch import needed)."""
    src_root = os.path.join(root, "src")
    findings = ast_rules.check_src(os.path.join(src_root, "repro_torch"),
                                   root)
    findings += reachability.check_reachability(root, src_root)
    return findings


def _contract(engine, name: str):
    """A backend's declared contract, or an error finding naming it."""
    contract = engine.BACKEND_CONTRACTS.get(name)
    if contract is None:
        return None, Finding(
            "contract", "error", "src/repro_torch/core/engine.py", 0,
            f"backend {name!r} is registered without a BackendContract in "
            "engine.BACKEND_CONTRACTS — declare its cross-batch reductions "
            "and host syncs")
    return contract, None


def collect_traced(root: str, device=None,
                   report: dict | None = None) -> list[Finding]:
    """The trace layer on ``device``: probe traces, contracts, shared
    memory, the recompilation harness (and on the card its graph-capture
    half). ``device=None`` is the card (``device.resolve_device``); the
    CPU only when asked for. ``report`` (a dict) receives each trace's cross-batch reduction
    count and kernel launches, and the graph-capture rows."""
    from ..core import engine
    from ..device import resolve_device
    from . import harness, probe, smem, trace_rules
    from .contracts import QuantContract

    device = resolve_device(device)
    findings: list[Finding] = []
    cfg = probe.probe_config()
    tainted = probe.batch_tainted_sizes(cfg)
    traces = {} if report is None else report.setdefault("traces", {})

    def note(name, trace):
        traces[name] = dict(
            ops=len(trace), launches=probe.launches(trace),
            cross_batch=len(trace_rules.batch_reductions(trace, tainted)))

    for name in engine.available_backends():
        contract, missing = _contract(engine, name)
        if missing:
            findings.append(missing)
            continue
        allowed = contract.allowed_host_syncs
        if contract.host_dispatch:
            for piece, trace in probe.trace_sparse_pieces(
                    cfg, device=device, root=root).items():
                note(piece, trace)
                declared = (contract.cross_batch_reductions
                            if piece.endswith("_stats") else 0)
                findings += trace_rules.check_dtypes(piece, trace, root)
                findings += trace_rules.check_host_sync(piece, trace, root,
                                                        allowed)
                findings += trace_rules.check_batch_purity(
                    piece, trace, tainted, declared, root)
                findings += trace_rules.check_no_int8_dequant(piece, trace,
                                                              root)
        else:
            label = f"backend:{name}"
            trace = probe.trace_backend(name, cfg, device=device, root=root)
            note(label, trace)
            findings += trace_rules.check_dtypes(label, trace, root)
            findings += trace_rules.check_host_sync(label, trace, root,
                                                    allowed)
            findings += trace_rules.check_batch_purity(
                label, trace, tainted, contract.cross_batch_reductions, root)
            findings += trace_rules.check_no_int8_dequant(label, trace, root)

    # the direct-training path: the loss forward obeys batch purity with the
    # dense backend's declared loss reductions; the full grad step is exempt
    # from the count (weight grads contract the batch) but keeps dtype +
    # host-sync discipline
    dense, missing = _contract(engine, "dense")
    train_declared = dense.train_loss_reductions if dense else 0
    for name, trace in probe.trace_train_step(cfg, device=device,
                                              root=root).items():
        note(name, trace)
        findings += trace_rules.check_dtypes(name, trace, root)
        findings += trace_rules.check_host_sync(name, trace, root)
        if name.startswith("training.loss_fn"):
            findings += trace_rules.check_batch_purity(
                name, trace, tainted, train_declared, root)

    # the int8 discipline, against each quant path's declared contract
    for name, trace in probe.trace_quant_kernels(device=device,
                                                 root=root).items():
        note(name, trace)
        findings += trace_rules.check_quant(name, trace, QuantContract(),
                                            root)
        findings += trace_rules.check_dtypes(name, trace, root)

    # the kernels of B1, B3 and B4 (plain versions on the CPU, the wrappers
    # around the launches on the card)
    for name, trace in probe.trace_kernels(cfg, device=device,
                                           root=root).items():
        note(name, trace)
        findings += trace_rules.check_dtypes(name, trace, root)
        findings += trace_rules.check_host_sync(name, trace, root)

    findings += smem.check_smem(root)
    findings += harness.check_recompilation(root, device)
    if device.type == "cuda":
        rows = None if report is None else report.setdefault("graphs", [])
        findings += harness.check_graph_capture(root, device, rows=rows)
    return findings


class Result:
    """One audit run: every finding, split against the baseline."""

    def __init__(self, findings, baseline: Baseline, device=None):
        self.findings = findings
        self.device = device
        gating = [f for f in findings if f.severity != "info"]
        self.gating = gating
        self.fresh, self.baselined, self.stale = baseline.split(gating,
                                                                device)
        self.errors = [f for f in self.fresh if f.severity == "error"]
        self.warnings = [f for f in self.fresh if f.severity == "warning"]

    def by_rule(self) -> dict:
        out: dict[str, int] = {}
        for f in self.gating:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


def run(root: str, *, trace: bool = True, device=None,
        baseline_path: str = DEFAULT_BASELINE,
        report: dict | None = None) -> Result:
    """Collect (the static layer, then the traced one on ``device``: the
    card unless the caller asks for the CPU) and split against the
    baseline. Raises BaselineError on a bad baseline."""
    from ..device import resolve_device

    if trace:
        device = resolve_device(device)
    findings = collect_static(root)
    if trace:
        findings += collect_traced(root, device, report)
    # entries naming a device come from a traced layer: a static run (no
    # device, "") sets them all aside
    dev = str(device) if trace else ""
    return Result(findings, Baseline.load(baseline_path), dev)


def _report(args, res: Result) -> str:
    verdict = ("✅ no findings outside the baseline" if not res.fresh else
               f"❌ {len(res.errors)} error(s), {len(res.warnings)} "
               "warning(s) outside the baseline")
    if not args.no_trace:
        verdict += f" (traced on {res.device})"
    sections = []
    if res.fresh:
        sections.append(("Findings outside the baseline",
                         gh_summary.markdown_table(
                             ["severity", "rule", "location", "message"],
                             [[f.severity, f.rule, f"`{f.location}`",
                               f.message] for f in sorted(res.fresh)])))
    if res.baselined:
        sections.append((
            "Baselined (accepted) findings",
            f"{len(res.baselined)} finding(s) matched `{args.baseline}`"))
    if res.stale:
        sections.append(("Stale baseline entries", gh_summary.markdown_table(
            ["rule", "file", "message"],
            [[e["rule"], f"`{e['file']}`", e["message"]] for e in res.stale])
            + "\n\nno longer observed — prune them from the baseline"))
    return gh_summary.render_report("Contract audit (`repro_torch.audit`)",
                                    verdict, sections)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.audit",
        description="the port's contract checker: trace + AST rules")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any non-baselined error OR warning (CI)")
    ap.add_argument("--no-trace", action="store_true",
                    help="AST/reachability only (fast; touches no device)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the traced layer runs (default: the card; "
                         "without one the run raises)")
    ap.add_argument("--root", default=repo_root(),
                    help="repo root (default: inferred from this file)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline path (default: the package's "
                         "baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current warnings")
    ap.add_argument("--json", default="", help="write findings JSON here")
    ap.add_argument("--summary", default="",
                    help="append the markdown report to this file "
                         "($GITHUB_STEP_SUMMARY in CI)")
    args = ap.parse_args(argv)

    try:
        res = run(args.root, trace=not args.no_trace, device=args.device,
                  baseline_path=args.baseline)
    except BaselineError as e:
        print(f"error: {e}")
        return 2

    if args.write_baseline:
        dev = None if args.no_trace else res.device
        keep = [e for e in Baseline.load(args.baseline).entries
                if e.get("device", dev) != dev]
        new = Baseline.from_findings(
            sorted(f for f in res.gating if f.severity == "warning"))
        Baseline(keep + new.entries).save(args.baseline)
        print(f"wrote {len(new.entries)} warning(s) to {args.baseline} — "
              "edit each entry's justification before committing "
              f"({len(res.errors)} error(s) NOT baselined; fix them)")

    report = _report(args, res)
    gh_summary.emit(report, args.summary)
    for f in sorted(res.fresh):
        print(f.render())
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "findings": [f.to_json() for f in sorted(res.fresh)],
                "baselined": [f.to_json() for f in sorted(res.baselined)],
                "stale_baseline": res.stale,
                "info": [f.to_json() for f in res.findings
                         if f.severity == "info"],
            }, fh, indent=2)

    if res.errors or (args.strict and res.warnings):
        return 1
    return 0
