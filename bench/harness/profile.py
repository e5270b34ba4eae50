"""Reduces a ``torch.profiler`` trace of a stretch of serving to the
device's busy time, its top operations and its idle gaps by what the host
was doing.

Device intervals come from the profiler's device events, one union per
card. Host phases are the runner's (``Program.host_phases``): named
intervals read on ``time.perf_counter``, moved onto the profiler's clock
by the offset between each step's ``bench.step`` marker (``STEP_MARK``,
which the runner's drive opens around every step) and the step's
``t_call``, the harness's reading before it.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch.autograd import DeviceType

STEP_MARK = "bench.step"


def start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (k, 2) intervals of (n, 2) ones."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.append(idx[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], 1)


def reduce(prof, log, t0: float, t1: float, n_devices: int,
           phases: list[tuple]) -> dict:
    """The trace of the stretch [t0, t1] (perf_counter seconds) whose
    steps ``log`` holds and whose host work ``phases`` names ((name, t0,
    t1) in time order): ``busy_s`` (mean over the cards), ``window_s``,
    ``device_s`` (device seconds by operation name, summed over the
    cards), ``device_ops`` and ``idle_gaps`` (at most ten each, seconds,
    largest first)."""
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    marks = [e.start_ns() for e in events if e.name() == STEP_MARK
             and e.device_type() == DeviceType.CPU]
    calls = list(log.step_array()["t_call"])
    if len(marks) != len(calls) or not calls:
        raise RuntimeError(f"{len(marks)} step markers in the trace for "
                           f"{len(calls)} steps")
    off = float(np.median(np.asarray(marks) * 1e-9 - np.asarray(calls)))
    lo, hi = (t0 + off) * 1e9, (t1 + off) * 1e9
    device_s = collections.Counter()
    per_dev = collections.defaultdict(list)
    for e in events:
        # a record_function range shows on the device's timeline too
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns()
        d = e.duration_ns()
        device_s[e.name()] += d * 1e-9
        per_dev[e.device_index()].append((max(s, lo), min(s + d, hi)))
    ph_t0 = np.asarray([(p[1] + off) * 1e9 for p in phases])
    ph_t1 = np.asarray([(p[2] + off) * 1e9 for p in phases])
    idle = collections.Counter()
    busy = []
    for dev in range(n_devices):
        iv = np.asarray(per_dev.get(dev, []), np.float64).reshape(-1, 2)
        iv = _union(iv[iv[:, 1] > iv[:, 0]])
        busy.append(float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9)
        edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
        for g0, g1 in edges[edges[:, 1] > edges[:, 0]]:
            covered = 0.0
            j = max(0, int(np.searchsorted(ph_t1, g0)) - 1)
            while j < len(phases) and ph_t0[j] < g1:
                ov = min(g1, ph_t1[j]) - max(g0, ph_t0[j])
                if ov > 0:
                    idle[phases[j][0]] += ov * 1e-9 / n_devices
                    covered += ov
                j += 1
            if g1 - g0 - covered > 0:
                idle["other"] += (g1 - g0 - covered) * 1e-9 / n_devices
    return {"busy_s": sum(busy) / max(n_devices, 1), "window_s": t1 - t0, "device_s": dict(device_s),
            "device_ops": [[k, v] for k, v in device_s.most_common(10)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the operations whose name holds any of ``names``."""
    return sum(s for k, s in trace["device_s"].items()
               if any(n in k for n in names))
