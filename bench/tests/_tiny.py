"""A small cell added to a copy of the benchmark as new files: a
configuration, a mix, a metric and a manifest entry each, driven on the CPU.
"""
import json
import shutil
import time
from pathlib import Path

import torch

from bench.harness import cell

ROOT = Path(__file__).resolve().parents[2]

TINY_NET = dict(spec="4C3-8C3-P4-8C3-10", input_hw=32, input_c=3, T=4,
                depth=16, mode="mttfs_cont", input_mode="analog",
                v_init_frac=0.5, compressed=True, vmem_resident=True)
# well below what the tiny net serves on one CPU core, so its open loop
# keeps no backlog
TINY_OPEN_RPS = 300.0


# the readers of an open loop's window and traced stretch
OPEN_READERS = (
    ("bucket_occupancy.open", "%", "higher", "program_counter", "runtime"),
    ("execute_ms.open", "ms", "lower", "program_span", "registry"),
    ("device_idle_share.open", "%", "lower", "device_trace", "device"))


def list_for(man, key, cell, **entry):
    """Lists ``cell`` under the metric ``entry["name"]`` of ``man[key]``,
    adding the entry where the manifest has no metric of that name."""
    for m in man[key]:
        if m["name"] == entry["name"]:
            m["workloads"].append(cell)
            return
    man[key].append(dict(entry, workloads=[cell]))


def tiny_checkout(tmp_path, *, chips=1):
    """A copy of the benchmark's files with one more configuration, a
    closed and an open mix with a cell each, and one more metric, each a
    new file or a new manifest entry: the open cell reports the tail
    (``latency_p99_ms``) and the three readers that move it."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/cifar10.json").read_text())
    cfg.update(name="tiny", net=TINY_NET, reference_block=8)
    cfg["serve"] = {"backend": "queue_pallas", "buckets": [1, 4, 8],
                    "chips": chips}
    # on the CPU the program accumulates events with a conv (the kernel's
    # plain version), not in queue order, so a threshold may tie the
    # other way there; on the card B1 adds in the reference's order
    cfg["limits"] = dict(missing=0, stats_mismatch_pct=25.0,
                                   logit_gap=1e-4, energy_mismatch=0,
                                   pred_mismatch=0)
    (root / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/tiny_closed.json").write_text(json.dumps(
        {"kind": "closed", "pool": 12, "backlog_buckets": 2,
         "warm": "largest"}))
    (root / "bench/traffic/tiny_open.json").write_text(json.dumps(
        {"kind": "poisson", "pool": 12, "rate_rps": TINY_OPEN_RPS}))
    (root / "bench/metrics/steps_served.py").write_text(
        "def read(ctx):\n    return float(len(ctx.steps['n']))\n")
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "bench/configs/tiny.json", "reduced": [],
                           "why": "test"})
    man["workloads"].append({"name": "tiny.closed", "config": "tiny",
                             "traffic": "tiny_closed", "chips": chips,
                             "why": "test"})
    man["workloads"].append({"name": "tiny.open", "config": "tiny",
                             "traffic": "tiny_open", "chips": chips,
                             "why": "test"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"] == "throughput_rps":
            m["workloads"].append("tiny.closed")
    list_for(man, "end_to_end", "tiny.open", name="latency_p99_ms",
             unit="ms", better="lower", bound=0.25, source="host_clock")
    for name, unit, better, source, layer in OPEN_READERS:
        list_for(man, "per_layer", "tiny.open", name=name, unit=unit,
                 better=better, source=source, layer=layer,
                 moves="latency_p99_ms")
    man["per_layer"].append({"name": "steps_served", "unit": "steps",
                             "better": "higher", "source": "program_span",
                             "layer": "runtime", "moves": "throughput_rps",
                             "workloads": ["tiny.closed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run_tiny(root, trace=False, seconds=0.3, seed=2**31 + 17,
             cell_name="tiny.closed"):
    torch.manual_seed(0)
    return cell.run(cell_name, seed, seconds, trace,
                    t_start=time.perf_counter(), device="cpu", root=root,
                    log=lambda *a, **k: None)
