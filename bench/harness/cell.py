"""One run of one cell: set-up, the measured window, an optional traced
stretch, the comparison with the reference, and the result line.

What is built, driven and judged is the runner's (``Program``), which the
cell's configuration names (``manifest.runner``); it judges by the
reference of the same name under ``bench/reference/``, which this module
hands it (``manifest.reference``). The order, the window, the traced
stretch and the metrics are this module's, whatever the runner. The order
is fixed by what each step may disturb. Set-up (the program's imports,
kernel libraries from the compile cache, weights and the inputs from the
seed, the program built and warmed on the shapes the cell uses) ends
where the window starts; nothing is built inside it. With ``--trace 1``
the window is followed by a stretch of the same traffic under
``torch.profiler`` alone (the program's own tracing stays off: its event
a response would lengthen the very host phases the stretch names), so
the window itself is never profiled. The peak device memory is read
before the program's state is freed; only then does the reference run.
"""
from __future__ import annotations

import collections
import gc
import sys
import time
from types import SimpleNamespace
from typing import Protocol

import numpy as np
import torch

from . import judge, manifest, profile

TRACE_SECONDS = 3.0          # the traced stretch after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class GcWatch:
    """Pauses of the interpreter's garbage collector, by generation."""

    def __init__(self):
        self.t, self.pauses = 0.0, collections.defaultdict(list)

    def __call__(self, phase, info):
        if phase == "start":
            self.t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self.t)

    def summary(self) -> str:
        return ", ".join(f"gen{g} {len(v)}x {sum(v) * 1e3:.1f} ms "
                         f"(max {max(v) * 1e3:.2f})"
                         for g, v in sorted(self.pauses.items()))


def _device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


class Program(Protocol):
    """A runner's class, ``bench/runners/<name>.py``'s ``Program``:
    ``Program(env, lap)`` is the program under test, built and warmed.
    ``env`` holds the cell's entry (``cell``), its configuration (``cfg``)
    and mix (``mix``), ``chips``, the torch device (``dev``), the ``seed``
    and the checkout's ``root``; ``lap(name)`` closes a named phase of
    set-up."""

    def new_log(self):
        """An empty log of a stretch of driving. Its ``step_array()`` maps
        at least ``n`` (requests completed by the step), ``t_call`` and
        ``t_done`` (perf_counter seconds around it) to an array a step."""

    def drive(self, log, *, mix: dict, seed: int, start_s: float,
              seconds: float) -> dict:
        """Drives ``seconds`` of the mix, logging every step into ``log``
        and opening ``profile.STEP_MARK`` around each; ``start_s`` (0 for
        the window, its end for the traced stretch) keys the stretch's own
        draws. Returns ``t0`` and ``t1``, the perf_counter seconds the
        stretch ran over, and for an open loop ``due`` (the requests due
        in it) and ``late`` (the generator's lateness: ``late_idle_s``,
        ``late_all_s``)."""

    def summary(self) -> dict:
        """The program's counters, read before and after the window."""

    def host_phases(self, log) -> list[tuple]:
        """(name, t0, t1) perf_counter intervals of the host's work in a
        stretch, in time order: what the idle gaps of a trace are
        attributed to."""

    def release(self) -> None:
        """Frees the program's state, keeping what ``compare`` needs."""

    def compare(self, window, traced, reference) -> SimpleNamespace:
        """Runs ``reference`` (the module ``bench/reference/<runner>.py``;
        a compare that calls none of it is refused) over what the window
        (and the traced stretch, or None) produced and judges it:
        ``checks`` ({name: (value, limit)}, all ``value <= limit`` for
        ``correct``), ``attempted``, ``failed``, ``about`` (a few words for
        the log) and ``ctx`` (the runner's fields for the metrics'
        readers)."""


def setup(cell: str, seed: int, *, t_start: float, device: str = "cuda",
          root=manifest.ROOT, w: dict | None = None) -> SimpleNamespace:
    """Everything before the window: the cell's files and its runner, and
    the program that runner builds and warms from the seed. ``setup_s``
    runs from ``t_start`` to the end of it. ``w``, a workload entry,
    stands in for a cell the manifest does not list."""
    man = manifest.load(root)
    w = w or manifest.workload(man, cell)
    cfg = manifest.config(man, w["config"], root)
    mix = manifest.traffic(w["traffic"], root)
    runner = manifest.runner(cfg["runner"], root)
    reference = manifest.reference(cfg["runner"], root)
    chips = w["chips"]
    dev = torch.device(device)
    phases, t = {"start": time.perf_counter() - t_start}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name], t = now - t, now

    prog = runner(SimpleNamespace(cell=w, cfg=cfg, mix=mix, chips=chips,
                                  dev=dev, seed=seed, root=root), lap)
    return SimpleNamespace(
        man=man, w=w, cfg=cfg, mix=mix, chips=chips, dev=dev, prog=prog,
        reference=reference, setup_s=time.perf_counter() - t_start,
        setup_phases=phases)


def run(cell: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", root=manifest.ROOT, log=print) -> dict:
    """Run ``cell`` once; returns the result line's object. ``device`` is
    the card unless a test drives the harness on the CPU."""
    s = setup(cell, seed, t_start=t_start, device=device, root=root)
    man, w, cfg, mix, chips = s.man, s.w, s.cfg, s.mix, s.chips
    dev, prog, setup_s, s_phases = s.dev, s.prog, s.setup_s, s.setup_phases
    reference = Watched(s.reference)
    del s
    window = prog.new_log()
    summary0 = prog.summary()
    watch = GcWatch()
    gc.callbacks.append(watch)

    # -- the window ---------------------------------------------------------
    d = prog.drive(window, mix=mix, seed=seed, start_s=0.0, seconds=seconds)
    t0, t1 = d["t0"], d["t1"]
    summary1 = prog.summary()
    gc.callbacks.remove(watch)

    # -- the traced stretch -------------------------------------------------
    traced = None
    if trace:
        gc.collect()
        traced = prog.new_log()
        prof = profile.start()
        dt = prog.drive(traced, mix=mix, seed=seed, start_s=seconds,
                        seconds=TRACE_SECONDS)
        trace_red = profile.reduce(prof, traced, dt["t0"], dt["t1"],
                                   chips if dev.type == "cuda" else 0,
                                   prog.host_phases(traced))
        log(f"[bench] traced stretch: {_rate(traced, dt['t0'], dt['t1']):.1f}"
            f" req/s over {dt['t1'] - dt['t0']:.3f} s, against "
            f"{_rate(window, t0, t1):.1f} in the window", file=sys.stderr)

    device_info = _device_info(dev, chips)
    prog.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference and the comparison -----------------------------------
    t_ref = time.perf_counter()
    verdict = prog.compare(window, traced, reference)
    if not reference.calls:
        raise RuntimeError(f"the {cfg['runner']!r} runner judged the run "
                           f"without calling its reference, "
                           f"{reference.module.__file__}")
    checks = verdict.checks
    log(f"[bench] reference {verdict.about} in "
        f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)

    # -- metrics ------------------------------------------------------------
    steps = window.step_array()
    n_done = int(steps["n"].sum())
    # what a metric's reader may read: the window's [t0, t1] and its steps
    # (the runner's ``step_array()``), the program's counters before and
    # after it, with --trace 1 the traced stretch's reduction and its
    # steps, and the runner's own fields (``Program.compare``)
    ctx = SimpleNamespace(
        cell=w, cfg=cfg, mix=mix, chips=chips, setup_s=setup_s, t0=t0, t1=t1,
        steps=steps, n_done=n_done, summary=(summary0, summary1),
        trace=trace_red if trace else None,
        traced_steps=traced.step_array() if traced is not None else None,
        **verdict.ctx)
    wanted = (manifest.per_layer(man, cell) if trace
              else manifest.end_to_end(man, cell))
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        elif not m["name"].endswith("_roofline"):
            # only a kernel's roofline may fall silent, where the kernel
            # has left the path; any other metric of the cell must read
            raise RuntimeError(f"metric {m['name']!r} of {cell} read "
                               f"nothing")
    late = d.get("late")
    if late is not None:
        log(f"[bench] open loop: {d['due']} requests due in {seconds:g} s; "
            f"generator lateness after a sleep p50/p99 "
            f"{_pct(late['late_idle_s'], 50):.1f}/"
            f"{_pct(late['late_idle_s'], 99):.1f} us over "
            f"{len(late['late_idle_s'])} admissions; every admission "
            f"p99 {_pct(late['late_all_s'], 99):.1f} us", file=sys.stderr)
    log(f"[bench] {cell} seed {seed}: {n_done} requests in "
        f"{t1 - t0:.3f} s, {len(steps['n'])} steps, "
        f"{_counted(summary0, summary1)}, set-up {setup_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in s_phases.items()) + ")",
        file=sys.stderr)
    svc = steps["t_done"] - steps["t_call"] if len(steps["n"]) else np.zeros(1)
    log(f"[bench] window: garbage collector {watch.summary() or 'idle'}; "
        f"step ms p50 {np.median(svc) * 1e3:.3f} max {svc.max() * 1e3:.3f}, "
        f"{int((svc > 2 * np.median(svc)).sum())} steps over twice the "
        f"median", file=sys.stderr)

    result = {"correct": judge.passed(checks),
              "attempted": verdict.attempted, "failed": verdict.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["device"]["busy_s"] = trace_red["busy_s"]
        result["device"]["window_s"] = trace_red["window_s"]
        result["breakdown"] = {"device_ops": trace_red["device_ops"],
                               "idle_gaps": trace_red["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"[check] {k} {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return result


class Watched:
    """A reference module whose calls are counted: the harness hands it to
    the runner's ``compare`` and refuses a verdict reached without it."""

    def __init__(self, module):
        self.module, self.calls = module, 0

    def __getattr__(self, name):
        value = getattr(self.module, name)
        if not callable(value) or isinstance(value, type):
            return value

        def call(*args, **kwargs):
            self.calls += 1
            return value(*args, **kwargs)
        return call


def _counted(summary0: dict, summary1: dict) -> str:
    """The window's work by the program's flat counters: each of its
    summary's dicts of numbers, less its reading before the window."""
    out = []
    for key, v1 in summary1.items():
        if isinstance(v1, dict) and all(isinstance(v, (int, float))
                                        for v in v1.values()):
            v0 = summary0.get(key, {})
            delta = {k: v - v0.get(k, 0) for k, v in v1.items()}
            out.append(f"{key} {delta}")
    return ", ".join(out) or "no counters"


def _rate(log, t0, t1):
    return float(log.step_array()["n"].sum()) / max(t1 - t0, 1e-9)


def _pct(a, q):
    return float(np.percentile(a, q) * 1e6) if len(a) else float("nan")
