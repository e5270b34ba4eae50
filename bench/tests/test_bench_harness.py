"""The harness's arithmetic and its manifest, on the CPU: rates over all
the work and all the time, the tail over every request, the operation and
byte counts behind ``mfu`` and ``b1_roofline`` at the CIFAR-10 shapes, the
manifest's legal names, and a cell, a mix, a metric and a runner added as
new files only."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.harness import manifest, roofline, serve, traffic
from bench.reference import snn

from _tiny import ROOT, list_for, run_tiny, tiny_checkout

CIFAR = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10"


# -- a runtime on a virtual clock ---------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeRuntime:
    """Takes up to 64 queued requests a step, in ladder buckets; a step
    costs ``cost(n)`` virtual seconds."""

    def __init__(self, clock, cost):
        self.clock, self.cost = clock, cost
        self.queue, self.next_rid = [], 0
        self.policy = SimpleNamespace(max_bucket=64)
        self.buckets = []

    def submit(self, image, model, arrival_s=None):
        self.queue.append(self.next_rid)
        self.next_rid += 1
        return self.next_rid - 1

    def pending(self):
        return len(self.queue)

    def step(self):
        taken, self.queue = self.queue[:64], self.queue[64:]
        bucket = next(b for b in (1, 4, 16, 64) if b >= len(taken))
        self.buckets.append((bucket, self.pending()))
        self.clock.t += self.cost(len(taken))
        row = lambda f: np.zeros((1, 3), np.int32)
        return [SimpleNamespace(
            rid=r, bucket=bucket, batch_form_s=1e-4, service_s=1e-3,
            price_s=2e-4, step_total_s=1.3e-3, logits=np.zeros(10, np.float32),
            pred=0, energy_j=0.0, model_latency_s=0.0,
            stats=SimpleNamespace(**{f: (np.zeros(1, np.int32)
                                         if f == "overflow" else row(f))
                                     for f in serve.STATS}))
                for r in taken]


def client(rt):
    return serve.Client(rt, "m", np.zeros((8, 2, 2, 1), np.float32))


def test_closed_loop_keeps_full_buckets_and_counts_all_work():
    clock = Clock()
    rt = FakeRuntime(clock, lambda n: 0.005)
    log = serve.Log()
    t0, t1 = serve.closed(client(rt), traffic.Draws(1, 8), 1.0, log,
                          backlog=3, clock=clock)
    steps = log.step_array()
    assert all(b == 64 and left >= 128 for b, left in rt.buckets)
    assert steps["t_done"][-1] == t1 >= t0 + 1.0
    ctx = SimpleNamespace(n_done=int(steps["n"].sum()),
                          t0=t0, t1=t1)
    rate = manifest.reader("throughput_rps")(ctx)
    assert rate == pytest.approx(64 * len(rt.buckets) / (t1 - t0))
    assert rate == pytest.approx(64 / 0.005)


def test_open_loop_times_every_request_from_its_due_time():
    clock = Clock()
    rt = FakeRuntime(clock, lambda n: 0.001 + 0.0001 * n)
    log = serve.Log()
    due = np.sort(np.concatenate([np.linspace(0, 0.5, 50),
                                  np.full(200, 0.6)]))   # a burst
    late = serve.open_loop(client(rt), traffic.Draws(1, 8), due, log,
                           t0=0.0, clock=clock,
                           sleep=lambda s: setattr(clock, "t", clock.t + s))
    lat = np.concatenate(log.latency)
    assert len(lat) == len(due) == sum(len(r) for r in log.rids)
    assert (lat > 0).all() and len(late["late_all_s"]) == len(due)
    ctx = SimpleNamespace(latency_s=lat)
    p99 = manifest.reader("latency_p99_ms")(ctx)
    assert p99 == pytest.approx(np.percentile(lat, 99) * 1e3)
    chunks = np.mean([np.percentile(c, 99) for c in log.latency]) * 1e3
    assert p99 != pytest.approx(chunks)


def test_poisson_rate_and_streams():
    due = traffic.poisson(2**31 + 7, 5000.0, 0.0, 20.0)
    assert len(due) / 20.0 == pytest.approx(5000, rel=0.03)
    assert (np.diff(due) >= 0).all() and due[-1] < 20.0
    again = traffic.poisson(2**31 + 7, 5000.0, 0.0, 20.0)
    assert np.array_equal(due, again)
    d = traffic.Draws(3, 1024)
    assert all(0 <= d.next() < 1024 for _ in range(10_000))


# -- the counts behind mfu and b1_roofline ------------------------------------

def test_counts_at_the_cifar10_shapes():
    stages, head = snn.plan(CIFAR, 32, 3)
    assert [(s.in_hw, s.in_c, s.out_c, s.pool, s.n_win) for s in stages] == [
        (32, 3, 32, 0, 11), (32, 32, 32, 3, 11), (10, 32, 64, 0, 4),
        (10, 64, 64, 3, 4), (3, 64, 128, 0, 1), (3, 128, 128, 0, 1),
        (3, 128, 128, 0, 1)]
    assert head == snn.Head(9, 1152, 10)
    # 30 inner coordinates take 3 taps, the two edges 2
    assert roofline.taps(32, 3) == 94
    assert roofline.analog_flops(stages[0]) == 2 * 94 * 94 * 3 * 32
    # bucket 64 at T=4: 256 rows of occupancy (32 channels, 9 phases,
    # 121 windows), the 3x3x32x32 weights, a 32x32x32 charge a row
    assert roofline.b1_call_bytes(stages[1], 256) == 4 * (
        256 * 32 * 9 * 121 + 9 * 32 * 32 + 256 * 32 * 32 * 32)
    assert roofline.b1_call_bytes(stages[4], 256) == 4 * (
        256 * 64 * 9 * 1 + 9 * 64 * 128 + 256 * 3 * 3 * 128)
    assert roofline.bound_s(3.35e12, 0) == 1.0
    assert roofline.bound_s(0, 67e12) == 1.0


def _ctx(chips, buckets):
    stages = snn.plan(CIFAR, 32, 3)[0]
    L = len(stages) + 1
    adds = np.arange(4 * L, dtype=np.int32).reshape(4, L) * 1000
    rids = []
    for k, b in enumerate(buckets):
        rids.append(np.arange(b) + 100 * k)
    pool_of_rid = np.arange(100 * len(buckets)) % 4
    return SimpleNamespace(
        chips=chips, cfg={"net": {"T": 4}},
        ref={"add_ops": adds}, stages=stages,
        traced_steps={"bucket": np.asarray(buckets, float)},
        traced_rids=rids, pool_of_rid=pool_of_rid,
        trace={"device_s": {"void fused_spike_accum_gather<3>(x)": 2e-3,
                            "fused_spike_accum_encode": 1e-3,
                            "sparse_gather_kernel": 5.0}},
        t0=0.0, t1=2.0, n_done=0, window_rids=np.arange(8),
        ref_all=adds)


@pytest.mark.parametrize("chips", [1, 4])
def test_b1_roofline_by_hand(chips):
    ctx = _ctx(chips, [64, 1])
    need = 0.0
    for b, rids in zip([64, 1], ctx.traced_rids):
        shards = chips if b % chips == 0 else 1
        k = b // shards
        imgs = ctx.pool_of_rid[rids]
        for s in range(shards):
            for li, st in enumerate(ctx.stages[1:], start=1):
                nb = roofline.b1_call_bytes(st, 4 * k)
                ops = ctx.ref["add_ops"][imgs[s * k:(s + 1) * k], li].sum()
                need += max(nb / 3.35e12, ops / 67e12)
    got = manifest.reader("b1_roofline")(ctx)
    assert got == pytest.approx(100 * need / 3e-3)


def test_mfu_by_hand():
    ctx = _ctx(1, [64])
    ctx.n_done = 8
    per = (roofline.analog_flops(ctx.stages[0])
           + ctx.ref["add_ops"][:, 1:].sum(1).astype(float))
    want = per[np.arange(8) % 4].sum() / (2.0 * 67e12) * 100
    assert manifest.reader("mfu")(ctx) == pytest.approx(want)
    ctx.chips = 4
    assert manifest.reader("mfu")(ctx) == pytest.approx(want / 4)


# -- the manifest ---------------------------------------------------------------

MAN = manifest.load(ROOT)
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _names():
    for key in ENTRY_KEYS:
        for e in MAN[key]:
            yield key, e


def test_manifest_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"] and MAN["command"][1] == "bench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for key, e in _names():
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[key] <= set(e) <= ENTRY_KEYS[key] | extra, e
        assert manifest.NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and key != "end_to_end" and key != "per_layer":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for key in ENTRY_KEYS:
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))


def test_manifest_references_resolve():
    cells = {w["name"]: w for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in cells.values()) <= 1
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    used = {w["config"] for w in cells.values()}
    for c in MAN["configs"]:
        assert c["name"] in used and c["reduced"] == []
        cfg = manifest.config(MAN, c["name"], ROOT)
        assert cfg["name"] == c["name"] and (ROOT / c["file"]).is_file()
        assert set(cfg["limits"]) == {"missing", "stats_mismatch_pct",
                                      "logit_gap", "energy_mismatch",
                                      "pred_mismatch"}
        assert manifest.runner(cfg["runner"], ROOT)
        assert manifest.reference(cfg["runner"], ROOT)
    for w in cells.values():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cfg = manifest.config(MAN, w["config"], ROOT)
        assert cfg["serve"]["chips"] == w["chips"]
        manifest.traffic(w["traffic"], ROOT)
        reported = {m["name"] for m in manifest.end_to_end(MAN, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.per_layer(MAN, w["name"])
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cellname in m.get("workloads", []):
            assert cellname in cells
            moved = e2e[m["moves"]]
            assert cellname in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for key in ("end_to_end", "per_layer"):
        for m in MAN[key]:
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


# -- a cell, a mix and a metric as new files ----------------------------------

def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    root = tiny_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (ROOT / "bench").rglob("*")
              if p.is_file() and ".cache" not in p.parts
              and "__pycache__" not in p.parts}
    r = run_tiny(root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"throughput_rps", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    r = run_tiny(root, trace=True)
    assert r["correct"] and r["metrics"]["steps_served"]["value"] > 0
    assert "busy_s" in r["device"] and "breakdown" in r
    for p in (tmp_path / "checkout" / "bench").rglob("*"):
        rel = p.relative_to(tmp_path / "checkout")
        orig = ROOT / rel
        if p.is_file() and orig in before:
            assert p.read_bytes() == before[orig], rel


TOY_RUNNER = '''"""A two-layer MLP in plain torch, float32, served on the CPU in a closed
loop of full batches drawn from a pool of rows; judged against the float64
reference ``bench/reference/toy.py`` on weights and rows copied before the
program saw them."""
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from bench.harness import profile


class Log:
    def __init__(self):
        self.steps, self.rows, self.out = [], [], []

    def step_array(self):
        a = np.asarray(self.steps, np.float64).reshape(-1, 3)
        return {"n": a[:, 0], "t_call": a[:, 1], "t_done": a[:, 2]}


class Program:
    new_log = Log

    def __init__(self, env, lap):
        d_in, d_hid, d_out = env.cfg["widths"]
        g = torch.Generator().manual_seed(env.seed)
        self.w1 = torch.randn(d_in, d_hid, generator=g) / d_in ** 0.5
        self.w2 = torch.randn(d_hid, d_out, generator=g) / d_hid ** 0.5
        self.pool = torch.randn(env.mix["pool"], d_in, generator=g)
        self.ref = [t.double().numpy().copy()
                    for t in (self.w1, self.w2, self.pool)]
        self.limits = env.cfg["limits"]
        lap("weights")
        self.forward(self.pool[: env.mix["batch"]])
        lap("warm_steps")

    def forward(self, x):
        return torch.relu(x @ self.w1) @ self.w2

    def drive(self, log, *, mix, seed, start_s, seconds):
        rng = np.random.default_rng([seed, int(start_s * 1e3)])
        t0 = t_done = time.perf_counter()
        while t_done < t0 + seconds:
            rows = rng.integers(0, len(self.pool), mix["batch"])
            t_call = time.perf_counter()
            with record_function(profile.STEP_MARK):
                out = self.forward(self.pool[rows])
            t_done = time.perf_counter()
            log.steps.append((len(rows), t_call, t_done))
            log.rows.append(rows)
            log.out.append(out.numpy())
        return {"t0": t0, "t1": t_done}

    def summary(self):
        return {"steps": {"toy": 0}}

    def host_phases(self, log):
        return [("toy.forward", t_call, t_done)
                for _, t_call, t_done in log.steps]

    def release(self):
        self.w1 = self.w2 = self.pool = None

    def compare(self, window, traced, reference):
        logs = [window] + ([traced] if traced is not None else [])
        rows = np.concatenate([r for lg in logs for r in lg.rows])
        out = np.concatenate([o for lg in logs for o in lg.out])
        w1, w2, pool = self.ref
        gap = float(np.abs(out - reference.mlp(w1, w2, pool[rows])).max())
        checks = {"max_abs_gap": (gap, self.limits["max_abs_gap"])}
        return SimpleNamespace(checks=checks, attempted=len(rows), failed=0,
                               about=f"over {len(rows)} rows", ctx={})
'''

TOY_REFERENCE = '''"""The toy MLP in float64 NumPy."""
import numpy as np


def mlp(w1, w2, x):
    return np.maximum(x @ w1, 0.0) @ w2
'''


def add_toy(root, runner=TOY_RUNNER, reference=TOY_REFERENCE):
    """Adds to the checkout ``root`` the toy runner and its reference (each
    where given), a configuration naming it, a mix and the cell
    ``toy.closed``, which reports ``throughput_rps`` and ``setup_s`` and,
    traced, ``steps_served``."""
    (root / "bench/runners/toy.py").write_text(runner)
    if reference is not None:
        (root / "bench/reference/toy.py").write_text(reference)
    (root / "bench/configs/toy.json").write_text(json.dumps(
        {"name": "toy", "runner": "toy", "widths": [64, 128, 10],
         "limits": {"max_abs_gap": 1e-4}}))
    (root / "bench/traffic/toy_closed.json").write_text(json.dumps(
        {"kind": "closed", "pool": 256, "batch": 32}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy", "source": "test",
                           "file": "bench/configs/toy.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "toy.closed", "config": "toy",
                             "traffic": "toy_closed", "chips": 1,
                             "why": "test"})
    for key, name in (("end_to_end", "throughput_rps"),
                      ("per_layer", "steps_served")):
        next(m for m in man[key] if m["name"] == name)["workloads"].append(
            "toy.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_a_new_runner_is_new_files_only(tmp_path, monkeypatch):
    """A configuration of another kind brings its runner as its own
    ``bench/runners/<name>.py`` and its reference as
    ``bench/reference/<name>.py``, beside its configuration, its mix and
    its cell: the harness runs it to a correct result with its metrics
    read, an answer altered where it is produced reads not correct, and no
    file of the benchmark changes."""
    root = tiny_checkout(tmp_path)
    copied = {p: p.read_bytes() for p in (ROOT / "bench").rglob("*")
              if p.is_file() and ".cache" not in p.parts
              and "__pycache__" not in p.parts}
    add_toy(root)

    r = run_tiny(root, cell_name="toy.closed")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"throughput_rps", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["max_abs_gap"]["value"] < 1e-5
    r = run_tiny(root, trace=True, cell_name="toy.closed")
    assert r["correct"] and r["metrics"]["steps_served"]["value"] > 0
    assert "busy_s" in r["device"] and "breakdown" in r

    relu = torch.relu
    monkeypatch.setattr(torch, "relu", lambda x: relu(x) + 1e-3)
    r = run_tiny(root, cell_name="toy.closed")
    assert not r["correct"], r["checks"]
    assert r["checks"]["max_abs_gap"]["value"] > 1e-4
    for orig, data in copied.items():
        assert (root / orig.relative_to(ROOT)).read_bytes() == data, orig


# a compare that reaches its verdict with a reference of its own
SELF_JUDGED = TOY_RUNNER.replace("reference.mlp(w1, w2, pool[rows])",
                                 "np.maximum(pool[rows] @ w1, 0.0) @ w2")


@pytest.mark.parametrize("runner, reference, error, want", [
    (TOY_RUNNER, None, ValueError,
     r"reference 'toy': there is no .*bench/reference/toy\.py"),
    (SELF_JUDGED, TOY_REFERENCE, RuntimeError,
     r"'toy' runner judged the run without calling its reference, "
     r".*bench/reference/toy\.py"),
], ids=["no_reference_file", "reference_not_called"])
def test_a_runner_is_judged_by_its_reference(tmp_path, runner, reference,
                                             error, want):
    """A runner is judged by the plain reference of its name under
    ``bench/reference/``, which the harness hands its ``compare``: a
    runner without that file is refused before anything is built, and a
    verdict reached without calling it is refused, not reported."""
    assert SELF_JUDGED != TOY_RUNNER
    root = tiny_checkout(tmp_path)
    add_toy(root, runner=runner, reference=reference)
    with pytest.raises(error, match=want):
        run_tiny(root, cell_name="toy.closed")


BURST_DRIVE = '''"""Bursts of ``burst`` requests every ``period_s`` on the wall clock."""
import numpy as np

from bench.harness import serve


def drive(client, draws, log, *, mix, seed, start_s, seconds):
    starts = np.arange(0.0, seconds, mix["period_s"])
    due = np.repeat(starts, mix["burst"])
    t0 = serve.time.perf_counter()
    late = serve.open_loop(client, draws, due, log, t0=t0)
    return {"t0": t0, "t1": serve.time.perf_counter(), "due": len(due),
            "late": late}
'''


def test_a_new_mix_kind_is_new_files_only(tmp_path):
    """A mix whose arrivals need code brings it as its own
    ``bench/traffic/<name>.py``; nothing of the harness changes."""
    root = tiny_checkout(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "bench").rglob("*") if p.is_file()}
    (root / "bench/traffic/tiny_burst.json").write_text(json.dumps(
        {"kind": "burst", "pool": 12, "burst": 6, "period_s": 0.05}))
    (root / "bench/traffic/tiny_burst.py").write_text(BURST_DRIVE)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny.burst", "config": "tiny",
                             "traffic": "tiny_burst", "chips": 1,
                             "why": "test"})
    list_for(man, "end_to_end", "tiny.burst", name="latency_p99_ms",
             unit="ms", better="lower", bound=0.25, source="host_clock")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    from bench.harness import cell

    r = cell.run("tiny.burst", 2**31 + 3, 0.3, False, t_start=0.0,
                 device="cpu", root=root, log=lambda *a, **k: None)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"latency_p99_ms", "setup_s"}
    assert r["attempted"] == 6 * 6
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel


def test_an_open_cell_reports_its_tail_and_its_readers(tmp_path,
                                                       monkeypatch):
    """A tiny open cell, added as files only, runs to its result line: its
    end-to-end metrics are the tail and the set-up, its traced run reads
    the three readers of the open loop."""
    root = tiny_checkout(tmp_path)
    r = run_tiny(root, cell_name="tiny.open")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"latency_p99_ms", "setup_s"}
    assert r["metrics"]["latency_p99_ms"]["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    # the CPU has no device for the profiler to see busy; the device
    # reader is handed a busy half of the traced stretch
    from bench.harness import profile

    real = profile.reduce

    def reduce(*a, **k):
        out = real(*a, **k)
        out["busy_s"] = out["window_s"] / 2
        return out
    monkeypatch.setattr(profile, "reduce", reduce)
    r = run_tiny(root, trace=True, cell_name="tiny.open")
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == {"bucket_occupancy.open", "execute_ms.open",
                        "device_idle_share.open"}
    assert 0 < got["bucket_occupancy.open"] <= 100
    assert got["execute_ms.open"] > 0
    assert got["device_idle_share.open"] == pytest.approx(50.0)


def test_open_and_closed_cells_report_their_own_metrics(tmp_path):
    """The rate belongs to the closed cells and the tail to an open one;
    the readers of bucket-64 steps are listed on the closed cells and stay
    off an open cell, whose window may run no bucket of 64."""
    closed = ("cifar10-closed", "svhn-closed", "cifar10-dp4-closed")
    phase = {"pull_ms.b64", "price_ms.b64", "respond_ms.b64",
             "copy_in_ms.b64", "launch_ms.b64", "sync_wait_ms.b64",
             "device_exec_ms.b64", "device_idle_share.window"}
    e2e = lambda man, c: {m["name"] for m in manifest.end_to_end(man, c)}
    layer = lambda man, c: {m["name"] for m in manifest.per_layer(man, c)}
    tiny = json.loads((tiny_checkout(tmp_path) / "BENCHMARK.json")
                      .read_text())
    for man in (MAN, tiny):
        for c in closed:
            assert e2e(man, c) == {"throughput_rps", "setup_s"}, c
            assert phase <= layer(man, c), c
    assert e2e(tiny, "tiny.open") == {"latency_p99_ms", "setup_s"}
    assert layer(tiny, "tiny.open") == {"bucket_occupancy.open",
                                        "execute_ms.open",
                                        "device_idle_share.open"}


def test_an_unknown_kind_without_its_code_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not built in"):
        serve.driver("nope", {"kind": "onoff"}, tmp_path)


def test_an_unknown_runner_is_refused(tmp_path):
    """A configuration whose runner has no file of its own fails before
    anything is built, naming the file looked for."""
    root = tiny_checkout(tmp_path)
    cfg_path = root / "bench/configs/tiny.json"
    cfg = json.loads(cfg_path.read_text())
    assert cfg["runner"] == "snn"
    cfg_path.write_text(json.dumps(dict(cfg, runner="nope")))
    want = r"runner 'nope': there is no .*bench/runners/nope\.py"
    with pytest.raises(ValueError, match=want):
        manifest.runner("nope", root)
    with pytest.raises(ValueError, match=want):
        run_tiny(root)


def test_a_listed_metric_that_reads_nothing_fails_the_run(tmp_path):
    root = tiny_checkout(tmp_path)
    (root / "bench/metrics/silent.py").write_text(
        "def read(ctx):\n    return None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "silent", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "runtime", "moves": "throughput_rps",
                             "workloads": ["tiny.closed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    with pytest.raises(RuntimeError, match="'silent' of tiny.closed read"):
        run_tiny(root, trace=True)
