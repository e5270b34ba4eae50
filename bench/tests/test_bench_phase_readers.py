"""The readers of the served step's phases and device times, by hand: a
fabricated pair of ``stats_summary()`` snapshots around a window on one
card and on four gives the expected ms and %, a window with no bucket-64
step reads nothing, and so does a program whose summary lacks the phase
and device sums. Then through the harness, on the CPU: a tiny cell that
lists the six phase readers reads them, and the three of the execute
phase add up to ``execute_ms.b64``."""
import json
from types import SimpleNamespace

import pytest

from bench.harness import manifest

from _tiny import run_tiny, tiny_checkout

PHASES = ("batch_form", "copy_in", "launch", "sync_wait", "pull", "price",
          "respond")
PHASE_READERS = ("copy_in", "launch", "sync_wait", "pull", "price", "respond")


def _summary(n64, scale, cards, device_scale, n1=0):
    """A ``stats_summary()`` after ``n64`` bucket-64 steps (and ``n1`` of
    bucket 1) whose phases took ``scale`` x (1..7) ms each, and each card
    ``device_scale`` x (card + 1) ms a step."""
    phase_s = {}
    device_s = {}
    for b, n in ((1, n1), (64, n64)):
        if n:
            phase_s[b] = {p: n * scale * (i + 1) * 1e-3
                          for i, p in enumerate(PHASES)}
            if cards:
                device_s[b] = {c: n * device_scale * (c + 1) * 1e-3
                               for c in range(cards)}
    return {"batches": n64 + n1, "served": 64 * n64 + n1,
            "padded_slot_fraction": 0.0,
            "bucket_histogram": {b: n for b, n in ((1, n1), (64, n64)) if n},
            "phase_s": phase_s, "device_s": device_s}


def _ctx(chips, before, after, seconds=2.0):
    return SimpleNamespace(summary=(before, after), chips=chips, t0=10.0,
                           t1=10.0 + seconds)


@pytest.mark.parametrize("chips", [1, 4])
def test_phase_and_device_readers_by_hand(chips):
    # 100 warm steps before the window, 500 in it, of bucket 64; 7 of
    # bucket 1 in it. A step's phases in the window: 1..7 x 0.2 ms
    before = _summary(100, 0.1, chips, 0.5)
    after = _summary(100, 0.1, chips, 0.5)
    win = _summary(500, 0.2, chips, 0.8, n1=7)
    for key in ("phase_s", "device_s"):
        for b, parts in win[key].items():
            acc = after[key].setdefault(b, {})
            for k, v in parts.items():
                acc[k] = acc.get(k, 0.0) + v
    after["bucket_histogram"] = {1: 7, 64: 600}
    ctx = _ctx(chips, before, after)
    for i, p in enumerate(PHASES[1:], start=1):
        got = manifest.reader(f"{p}_ms.b64")(ctx)
        assert got == pytest.approx(0.2 * (i + 1)), p
    # each card c: 0.8 x (c + 1) ms a window step; the mean over cards
    mean = sum(0.8 * (c + 1) for c in range(chips)) / chips
    assert manifest.reader("device_exec_ms.b64")(ctx) == pytest.approx(mean)
    busy = sum(507 * 0.8 * (c + 1) * 1e-3 for c in range(chips))
    assert manifest.reader("device_idle_share.window")(ctx) == \
        pytest.approx(100 * (1 - busy / (2.0 * chips)))


def test_readers_read_nothing_without_bucket_64_steps():
    before = _summary(3, 0.1, 1, 0.5)
    after = _summary(3, 0.1, 1, 0.5, n1=9)
    ctx = _ctx(1, before, after)
    for p in PHASE_READERS:
        assert manifest.reader(f"{p}_ms.b64")(ctx) is None
    assert manifest.reader("device_exec_ms.b64")(ctx) is None
    # bucket 1 alone still keeps the card busy
    assert manifest.reader("device_idle_share.window")(ctx) == \
        pytest.approx(100 * (1 - 9 * 0.5e-3 / 2.0))


def test_readers_read_nothing_from_a_summary_without_the_sums():
    def bare(n):
        return {"batches": n, "served": 64 * n, "padded_slot_fraction": 0.0,
                "bucket_histogram": {64: n}}

    ctx = _ctx(1, bare(3), bare(40))
    for p in PHASE_READERS:
        assert manifest.reader(f"{p}_ms.b64")(ctx) is None
    assert manifest.reader("device_exec_ms.b64")(ctx) is None
    assert manifest.reader("device_idle_share.window")(ctx) is None
    # on the CPU the phases read and the device times do not
    cpu = _ctx(1, _summary(3, 0.1, 0, 0.0), _summary(40, 0.1, 0, 0.0))
    assert manifest.reader("pull_ms.b64")(cpu) == pytest.approx(0.5)
    assert manifest.reader("device_exec_ms.b64")(cpu) is None
    assert manifest.reader("device_idle_share.window")(cpu) is None


def test_phase_readers_through_a_tiny_cell_on_the_cpu(tmp_path):
    """A tiny cell whose bucket is 64, listing the six phase readers: a
    traced run reads them all, and copy_in, launch and sync_wait add up
    to the response fields' ``execute_ms.b64``."""
    root = tiny_checkout(tmp_path)
    cfg_path = root / "bench/configs/tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["serve"]["buckets"] = [1, 64]
    cfg_path.write_text(json.dumps(cfg))
    man = json.loads((root / "BENCHMARK.json").read_text())
    for p in PHASE_READERS:
        man["per_layer"].append({
            "name": f"{p}_ms.b64", "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "test",
            "moves": "throughput_rps", "workloads": ["tiny.closed"]})
    for m in man["per_layer"]:
        if m["name"] in ("execute_ms.b64", "host_share.closed"):
            m["workloads"].append("tiny.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    r = run_tiny(root, trace=True, seconds=0.5)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert all(got[f"{p}_ms.b64"] > 0 for p in PHASE_READERS), got
    exe = got["copy_in_ms.b64"] + got["launch_ms.b64"] + got[
        "sync_wait_ms.b64"]
    assert exe == pytest.approx(got["execute_ms.b64"], rel=1e-6)
