"""Drives the program's serving runtime: builds it, warms the cell's buckets
and runs the closed or the open loop on the wall clock, keeping every
response in a compact log for the comparison and the metrics.

A traffic mix of the SNN runner (``bench/runners/snn.py``) is driven by a
function ``drive(client, draws, log, *, mix, seed, start_s, seconds) ->
dict``: the built-in one of the mix's ``kind`` (``closed``, ``poisson``),
or the ``drive`` of the mix's own ``bench/traffic/<name>.py`` where it has
one. It serves ``seconds`` of the mix through the client, logging every
step and response; ``start_s`` (0 for the window, its end for the traced
stretch after it) keys the stretch's own draws. It returns ``t0`` and
``t1``, the perf_counter seconds the stretch ran over, and for an open
loop ``due``, the requests due in it, and ``late``, the generator's
lateness (``open_loop``).

Everything the program does happens inside ``ServeRuntime.step``; what the
harness does between steps (admitting requests, recording responses,
waiting for the next arrival) is the client's work, and is kept small.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
from torch.profiler import record_function

from . import manifest, traffic
from .profile import STEP_MARK

STEP_FIELDS = ("bucket", "n", "batch_form_s", "service_s", "price_s",
               "step_total_s", "t_call", "t_done")
STATS = ("events_in", "spikes_out", "add_ops", "queue_words", "overflow")


class Log:
    """Responses and steps of one stretch of serving, condensed per step."""

    def __init__(self):
        self.steps: list[tuple] = []
        self.rids, self.logits, self.preds = [], [], []
        self.energy, self.model_latency = [], []
        self.stats = {f: [] for f in STATS}
        self.latency: list[np.ndarray] = []
        self.phases: list[tuple] = []   # (name, t0, t1) of client work

    def add(self, responses, t_call: float, t_done: float) -> np.ndarray:
        r0 = responses[0]
        self.steps.append((r0.bucket, len(responses), r0.batch_form_s,
                           r0.service_s, r0.price_s, r0.step_total_s,
                           t_call, t_done))
        rids = np.fromiter((r.rid for r in responses), np.int64,
                           len(responses))
        self.rids.append(rids)
        self.logits.append(np.stack([r.logits for r in responses]))
        self.preds.append(np.fromiter((r.pred for r in responses), np.int64,
                                      len(responses)))
        self.energy.append(np.fromiter((r.energy_j for r in responses),
                                       np.float64, len(responses)))
        self.model_latency.append(np.fromiter(
            (r.model_latency_s for r in responses), np.float64,
            len(responses)))
        for f in STATS:
            self.stats[f].append(np.concatenate(
                [getattr(r.stats, f) for r in responses]))
        return rids

    def step_array(self) -> dict:
        a = np.asarray(self.steps, np.float64).reshape(-1, len(STEP_FIELDS))
        return {f: a[:, i] for i, f in enumerate(STEP_FIELDS)}

    def arrays(self) -> dict:
        cat = lambda xs, d: np.concatenate(xs) if xs else np.zeros(0, d)
        out = {"rid": cat(self.rids, np.int64),
               "pred": cat(self.preds, np.int64),
               "energy_j": cat(self.energy, np.float64),
               "model_latency_s": cat(self.model_latency, np.float64),
               "latency_s": cat(self.latency, np.float64)}
        out["logits"] = (np.concatenate(self.logits) if self.logits
                         else np.zeros((0, 0), np.float32))
        for f in STATS:
            out[f] = np.concatenate(self.stats[f]) if self.stats[f] else None
        return out


def build(cfg: dict, params, thresholds, *, chips: int, device):
    """The registry and runtime serving ``cfg``'s net: (runtime, model
    name, handle). Over ``chips`` > 1 cards the runtime serves through a
    data mesh (a sharded plan per bucket that divides it)."""
    from repro_torch.core import engine
    from repro_torch.parallel import DataMesh, data_mesh
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime

    net = cfg["net"]
    snn_cfg = engine.SNNConfig(
        spec=net["spec"], input_hw=net["input_hw"], input_c=net["input_c"],
        T=net["T"], mode=net["mode"], depth=net["depth"],
        compressed=net["compressed"], input_mode=net["input_mode"],
        v_init_frac=net["v_init_frac"])
    registry = ModelRegistry(device=device)
    handle = registry.register(cfg["name"], params, thresholds, snn_cfg,
                               backend=cfg["serve"]["backend"],
                               vmem_resident=net["vmem_resident"])
    mesh = None
    if chips > 1:
        mesh = (data_mesh(chips) if registry.device.type == "cuda"
                else DataMesh((registry.device,) * chips))
    policy = BucketPolicy(tuple(cfg["serve"]["buckets"]))
    return ServeRuntime(registry, policy, mesh=mesh), cfg["name"], handle


class Client:
    """Submits requests and keeps the rid -> pool index map."""

    def __init__(self, runtime, model: str, pool: np.ndarray):
        self.rt, self.model, self.pool = runtime, model, pool
        self.pool_of_rid: list[int] = []

    def submit(self, index: int, arrival_s: float | None = None) -> int:
        rid = self.rt.submit(self.pool[index], self.model,
                             arrival_s=arrival_s)
        if rid != len(self.pool_of_rid):
            raise RuntimeError(f"runtime gave rid {rid}, expected "
                               f"{len(self.pool_of_rid)}")
        self.pool_of_rid.append(index)
        return rid

    def warm(self, buckets, draws: traffic.Draws, repeats: int = 3) -> None:
        """Serve ``repeats`` full batches of each bucket through the whole
        step (batching, execution, pricing, responses) before the window."""
        for b in buckets:
            for _ in range(repeats):
                for _ in range(b):
                    self.submit(draws.next())
                while self.rt.pending():
                    self.rt.step()


def closed(client: Client, draws: traffic.Draws, seconds: float, log: Log,
           *, backlog: int, clock=time.perf_counter) -> tuple[float, float]:
    """Saturated closed loop: ``backlog`` full largest buckets stay queued,
    each completed request is replaced at once. Steps until ``seconds``
    have passed; returns (start, end of the last step)."""
    rt = client.rt
    need = backlog * rt.policy.max_bucket
    while rt.pending() < need:
        client.submit(draws.next())
    t0 = clock()
    t_end = t0 + seconds
    t_done = t0
    while t_done < t_end:
        t_call = clock()
        with record_function(STEP_MARK):
            responses = rt.step()
        t_done = clock()
        log.add(responses, t_call, t_done)
        for _ in range(len(responses)):
            client.submit(draws.next())
        log.phases.append(("client.record_admit", t_done, clock()))
    return t0, t_done


def open_loop(client: Client, draws: traffic.Draws, due: np.ndarray,
              log: Log, *, t0: float, clock=time.perf_counter,
              sleep=time.sleep) -> dict:
    """Open loop on the wall clock: request i is due at ``t0 + due[i]``
    and is admitted with that arrival time at the first moment the loop
    sees it due; the loop steps whenever anything is queued and sleeps
    only when nothing is. Each request's latency runs from its due time
    to the moment the loop holds its response. Runs until every request
    is served; returns the generator's lateness (seconds past due of the
    admissions made after a sleep, and of all admissions)."""
    rt = client.rt
    n, i = len(due), 0
    base = len(client.pool_of_rid)
    due_abs = t0 + due
    late_idle, late_all = [], np.empty(n)
    woke = False
    while True:
        now = clock()
        while i < n and due_abs[i] <= now:
            client.submit(draws.next(), arrival_s=float(due_abs[i]))
            late_all[i] = now - due_abs[i]
            if woke:
                late_idle.append(now - due_abs[i])
            i += 1
        woke = False
        if rt.pending():
            t_call = clock()
            with record_function(STEP_MARK):
                responses = rt.step()
            t_done = clock()
            rids = log.add(responses, t_call, t_done)
            log.latency.append(t_done - due_abs[rids - base])
            log.phases.append(("client.record_admit", t_done, clock()))
        elif i < n:
            t_wait = clock()
            wait = due_abs[i] - t_wait
            if wait > 0:
                sleep(wait)
            woke = True
            log.phases.append(("client.wait", t_wait, clock()))
        else:
            break
    return {"late_idle_s": np.asarray(late_idle), "late_all_s": late_all}


# -- drivers ------------------------------------------------------------------

def drive_closed(client, draws, log, *, mix, seed, start_s, seconds):
    t0, t1 = closed(client, draws, seconds, log,
                    backlog=mix["backlog_buckets"])
    return {"t0": t0, "t1": t1}


def drive_poisson(client, draws, log, *, mix, seed, start_s, seconds):
    due = traffic.poisson(seed, mix["rate_rps"], start_s, seconds) - start_s
    t0 = time.perf_counter()
    late = open_loop(client, draws, due, log, t0=t0)
    return {"t0": t0, "t1": time.perf_counter(), "due": len(due),
            "late": late}


KINDS = {"closed": drive_closed, "poisson": drive_poisson}


def driver(name: str, mix: dict, root: Path):
    """The ``drive`` function of the mix ``name``: that of
    ``bench/traffic/<name>.py`` where the mix has such a file, else the
    built-in one of its ``kind``."""
    path = Path(root) / "bench" / "traffic" / f"{name}.py"
    if path.is_file():
        return manifest.load_file(path, "traffic").drive
    if mix.get("kind") not in KINDS:
        raise ValueError(f"mix {name!r}: kind {mix.get('kind')!r} is not "
                         f"built in ({sorted(KINDS)}) and there is no "
                         f"{path}")
    return KINDS[mix["kind"]]
