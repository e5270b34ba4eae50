#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of the SNN serving, study and training paths,
and of the LM stack, on one CUDA card.

    python3 chip_smoke.py

Phases (each one fails loudly; the script exits non-zero on any failure):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — compiles every kernel under ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel) into the kernel compile cache
   (``core.compile_cache``), here ``chiprun_out/fleet/kernels``: the
   directory the fleet phase's replicas share; the cache's hit / miss /
   put counts are printed.
3. kernels — at the CIFAR-10 serve shapes (bucket 64, T=4): the fused spike
   kernel (B1) on every conv stage's real occupancy, at depth 64 and 256,
   called as ``queue_pallas`` calls it (``steps`` = T, one launch), with
   the net's Gaussian weights held bit-exactly against the (c,
   phase)-ordered oracle (``ref.fused_spike_accum_ordered_ref``, the order
   of adds the kernel keeps) and to 1e-4 against its plain PyTorch version,
   and dyadic weights bit-exactly against both the plain version and the
   scatter oracle; its per-sample queue statistics (events kept, dropped,
   scalar adds) bit-exactly against the plain version's; the int8 head kernel (B2) at M in {1, 4, 16, 64},
   K=1152, N=10, and at kernel_bench's (256, 256, 256), bit-exactly, with
   its device time by profiler beside the CUDA-event time and
   ``torch._int_mm``'s; the sparse kernel (B3) on the same occupancy
   at depth 64: fp32 on dyadic weights bit-exact and on Gaussian weights to
   1e-4 against its plain version, and bit-exact against the ordered oracle
   and B1; ``weight_bits=8`` bit-exact against its plain version and
   ``ref.fused_spike_accum_quant_ref``, and against its library yardstick
   (cuDNN on the integer weights in fp32, times the scale); and a ragged
   case (1/8 of the rows active, ``n_rows`` < N) bit-exact and timed beside
   B1. Each is timed with CUDA events beside its plain version, a library
   call and its bound.
   Then C3: B1, B3 and B4 at K = 3 on 128x128 and 512x512 maps (past the
   old staged-bits limit) and at K = 9 and 11 (the rolled gather), each
   bit-exact against the (c, phase)-ordered oracle (B4 also in bf16 and on
   repeated words; B3 w8 against the quantized oracle); B3 w8 at K = 7,
   C_in = 2,720 (sums past 2^24, in int32); B5 at depth 65,536; timed.
4. serve   — the full-width CIFAR-10 net (paper Table 6) behind the port's
   ModelRegistry + ServeRuntime on ``queue_pallas``, one fp32 handle and
   one ``weight_bits=8`` handle, each bucket one CUDA graph captured at
   warmup (the memory the graphs reserve is printed), loaded by the port's
   ``serve/bench.py`` ``closed_loop`` as the reference's bench loads it:
   all 256 requests (its default) submitted, then the queue drained;
   repeated ``SERVE_RUNS`` times per handle. Launch counters are zeroed
   just before registration and read just after the runs; a replay runs no
   wrapper, so the gates read the handles' captured launches times their
   replays: B1 6 per executed bucket, B2 1 per bucket of the w8 handle.
   Per-request energies must equal a one-shot ``price_record`` and a
   one-shot ``infer_batch`` + ``price_record``. Then the open loop
   (Poisson arrivals on a virtual clock) at 1/4 and 1/2 of each handle's
   closed-loop rate: latency p50/p99 and the bucket histogram. Graph
   replay must equal the eager ``infer_batch`` of the same rows bit for bit
   (logits and all five stats) at every bucket, full and partly filled (n
   = b//2 + 1 valid rows, other images in the rest), on the Gaussian and
   the dyadic fp32 and w8 handles; kernel results must equal the port's
   CPU run (plain versions) on a small dyadic input.
5. sparse  — ``engine.infer_batch(..., backend="queue_sparse")`` on the
   full-width net at bucket 64: Gaussian and dyadic nets, fp32 and
   ``weight_bits=8``, analog input, and binary (TTFS) input once. Counters
   are zeroed just before these calls and read just after: B3 must launch
   6 times per analog call and 7 per binary call, B1 never, B2 once per w8
   call. Held: fp32 stats and logits equal ``queue_pallas``'s (dyadic and
   Gaussian: B3 adds in B1's order) and, on the dyadic net,
   ``queue_ref``'s; w8 equals ``queue_ref``'s on both nets; padded
   (n = 33 of 64) equals unpadded on the Gaussian net for both heads. Then
   ``PROFILE_WINDOWS`` windows of 5 bucket-64 calls each of
   ``queue_sparse`` and ``queue_pallas`` in turns: wall, device busy and
   idle share per window.
6. word    — the word-level ``queue`` path and the ``dense`` backends on the
   full-width net at bucket 64. B5 (queue encoder) on every event-driven
   stage's real occupancy rows, analog and binary input, bit-exact against
   its plain version; B4 (event accumulate: decode + gather) on each
   stage's real queues at every step, Gaussian weights bit-exact against the
   (c, phase)-ordered oracle started from the membrane and to 1e-4 against
   its plain version, dyadic weights bit-exact against the plain version,
   and in bf16 at the binary-input stage's first step (bit-exact against
   the ordered oracle in bf16, from the membrane and from zero; against its
   bf16 plain version within the worst-case bound of two orders of rounded
   adds), and at each stage's first step once more with every live word
   written twice (fp32 and bf16 bit-exact against the ordered oracle on the
   decode's multiplicities, dyadic bit-exact and Gaussian to 1e-4 against
   the plain version); B6 (MoE row gather) at
   ``benchmarks/kernel_bench.py``'s shape and the test shapes, f32 and
   bf16, and at a bytes-bound (T, d, S) = (4096, 4096, 8192) in bf16,
   bit-exact; each timed beside its plain version, a library call where
   one exists, and its bound. Then
   ``engine.infer_batch(..., backend="queue")`` on the Gaussian and the
   dyadic net, fp32 and ``weight_bits=8``, analog input, and binary input
   once, with the counters zeroed just before and read just after: B5 must
   launch 6 times and B4 24 times per analog call (7 and 28 per binary
   call), B1 and B3 never, B2 once per w8 call. Held: dyadic stats and
   logits equal ``queue_pallas``'s (reported, not held, on the Gaussian
   net: the two add in another order); padded (n = 33 of 64) == unpadded;
   per-sample ``engine.infer`` on 3 images == those rows of the batch.
   ``dense`` and ``dense_unrolled``: stats equal the port's CPU run on a
   small input, padded == unpadded, ``infer`` == the batch rows. Then
   ``PROFILE_WINDOWS`` windows of 5 bucket-64 calls each of ``queue`` and
   ``dense`` in turns.
7. profile — bucket-64 executions per serving handle, in
   ``PROFILE_WINDOWS`` windows of graph replays and, in turns, of the eager
   ``infer_batch`` call: each window's wall time and device time by kernel
   (torch.profiler) come from the same calls, so the device's idle share
   is read within one window; the spread across windows is printed, and
   the port's kernels are counted by name per replay (B1's gather 6, B2 1
   on the w8 handle).
8. study   — the paper's experiment through the port's study API:
   ``study.run(StudySpec("cifar10", backend="queue_pallas"))`` with a
   fresh in-memory ``StudyCache``: the full-width CIFAR-10 net trained
   (fake-quant AdamW, StudySpec's recipe: 2,048 images x 6 epochs),
   converted (percentile 99, greedy balancing over ``dense``), collected
   on 256 eval images in batches of 64 and priced; then a 4-variant
   pricing sweep (compressed x vmem_resident) on the same cache. Counters
   are zeroed just before and read just after: one train, one convert, one
   collect, and B1 6 x 4 = 24 launches. Printed: the report's summary
   rows, each stage's seconds and the final training loss. The same
   converted net is collected on ``queue_sparse`` at ``weight_bits=8`` (B3
   6 and B2 1 per batch, by counters), both reports' overflow printed; and
   served through ``build_runtime(spec, trained=True)`` (``register_study``
   on the same cache: no stage re-runs), 64 requests, whose energies must
   equal a one-shot collect + price bit for bit.
9. direct  — direct surrogate-gradient training through the port's study
   API: ``study.run(StudySpec("cifar10", training="direct",
   backend="queue_pallas"))`` on the study phase's cache (the CNN ``train``
   a hit): the same net trained by StudySpec's own recipe (2,048 images x
   4 epochs, batch 128: 64 AdamW steps through ``engine.train_forward``,
   superspike beta 10, target ``count``), collected on ``queue_pallas``
   and priced. Counters are zeroed just before and read just after: stage
   executions train_snn 1 and collect 1, 64 optimizer steps, B1 6 x 4 = 24
   launches and no other kernel, overflow 0. Then a second training of the
   spec on a fresh cache (params bit-equal); a resume on 256 images (2
   epochs with checkpoints, then to 3) bit-equal to 3 uninterrupted
   epochs; ``STEP_WINDOWS`` profiled windows of 5 training steps of the
   trained net at batch 128 (wall, device busy, idle share, top kernels);
   on dyadic params and images at batch 8, ``train_forward``'s
   spikes equal ``infer_batch(..., "dense")``'s and its summed step logits
   those logits to 1e-4, and the loss and every gradient on the card match
   the port's CPU run (``GRAD_TOL`` of each gradient's norm); an
   ``export_artifact`` / ``load_artifact`` round trip whose collect stats
   and logits equal the original's bit for bit; ``encode_rate`` with a
   CUDA generator (one seed one raster, mean rate within 0.05 of 0.5).
   Printed: the report's rows, ``train_snn``'s seconds, ms a step, the
   final loss, and the SNN accuracy beside the converted net's.

10. obs    — the full-width net's fp32 handle served by the closed loop
   (256 requests) ``OBS_RUNS`` times with tracing off and as often with it
   on (``repro_torch.obs``), in turns: every response (logits, stats,
   float32 energy) bit-identical across all runs; each traced run's trace
   holds ``serve.execute`` and ``serve.price`` spans, one ``serve.request``
   event a request and ``serve.requests`` equal to the count;
   ``python -m repro_torch.obs summarize`` renders the last one. Printed:
   traced and untraced req/s, median (min–max).
11. fleet  — a registry of the fp32 ``queue_pallas`` handle and its
   ``weight_bits=8`` twin at buckets (1, 4, 16, 64), saved
   (``save_registry``) under ``chiprun_out/fleet/registry``, restored
   in-process (``load_registry``: every bucket's graph re-captured,
   ``compile_count`` 0) and each bucket's replay, full and partly filled,
   held bit-equal to the builder's; then ``python -m
   repro_torch.serve.fleet --replicas 2 --dataset cifar10 --buckets
   1,4,16,64 --cache-dir chiprun_out/fleet``: each replica must report
   zero compile-cache misses (the build phase paid them) and
   ``compile_count`` 0, the two must answer bit-identically, and equal the
   in-process restored registry on the same requests. Printed: each
   replica's ``first_response_s``, ``restore_s`` and ``warmup_s``, and the
   B1 and B2 launches of the phase's window (captures and replays,
   in-process and per replica).

12. parallel — data-parallel execution on the card over a 2- and a 4-way
   virtual mesh on the first card (and every card when there is more than
   one): ``parallel.infer_batch_sharded`` at B in {1, 3, 16, 64} on
   ``dense`` and ``queue_pallas``, fp32 and ``weight_bits=8``, bit-equal
   to ``engine.infer_batch`` (logits and every stat), with the counts
   zeroed just before and read just after: B1 6 launches a shard and B2 1;
   ``use_mesh`` routing ``engine.infer_batch`` (queue_pallas sharded,
   queue_sparse on the local runner, both equal). Serving: a registry of
   the fp32 and w8 handles behind ``ServeRuntime(..., mesh=...)`` for each
   mesh, buckets (1, 4, 16, 64), a closed loop of 256 requests a handle
   whose responses (logits, stats, energies) equal the unsharded
   runtime's; the graphs' reserved memory per mesh; bucket-64 replays of
   each in turns (wall, device busy, idle share: on one card the shards
   share its SMs, so these are readings); ``set_mesh`` on the live
   registry drops every plan and re-captures each bucket once; and the
   fleet phase's registry restored with ``load_registry(mesh=)`` builds no
   plan at load and answers alike.
13. sweep  — the paper grid (``study.sweep.paper_grid()``: 3 datasets x
   ``dense``, ``queue_pallas`` x 8 pricing variants = 48 cells, StudySpec's
   own recipe) through ``run_sweep`` into ``chiprun_out/sweep``, killed
   after ``SWEEP_KILL_AFTER`` cells and resumed by a second call over the
   same directories: the two calls together train 3 times, convert 3 and
   collect 6 (nothing twice), and a third call resumes all 48 and runs no
   stage. B1's launches in the window equal the queue_pallas collects'.
   A cached train lookup is timed per dataset. One (mnist,
   ``queue_pallas``) pair is swept again with ``fresh=True`` on a 2-way
   mesh over train and convert on disk: one collect, B1 6 a shard a batch,
   rows equal to the grid's. Then the converted-vs-direct grid on MNIST
   (``paper_grid(direct=True, datasets=("mnist",), pricing=
   QUICK_PRICING)``) with its pairing section. Printed: seconds a cell
   (p50, p95, max), stage executions, the grid's seconds and first rows.
14. audit  — run right after the build: the port's contract checker
   (``repro_torch.audit``) with its traced layer on the card — every
   backend's plan, queue_sparse's pieces, direct training, the int8 paths
   and the B1/B3/B4 wrappers recorded with their kernel launches, the
   recompilation harness and its graph-capture half (a second warmup
   leaves ``compile_count`` flat; each captured graph's launches equal one
   eager call's) — with no finding outside ``audit/baseline.json``; then
   each kernel's ``smem_blocks`` against the dynamic shared memory its
   compiled launcher requests (the ``*_smem`` queries) at every paper
   geometry and at C3's shapes. One line: findings by rule, baselined,
   smem pairs checked, the flatness result.

15. lm     — run right after the audit: the LM stack (``models/``) with
   Qwen1.5-MoE-A2.7B's dimensions (``tests/_smoke_archs.py:95-103``,
   spelled out with the port's ``ArchConfig``), random weights from a
   CUDA generator. Serving at full width and depth (24 layers, 14.3 G fp32
   parameters): 4 prompts of 512 tokens from ``TokenStream`` prefilled,
   then 16 greedy decode steps; every B6 dispatch buffer of a checked
   prefill and decode held bit for bit against ``moe_gather_plain`` on the
   same words; B6 launches 24 a prefill and 24 a decode step (counts
   zeroed just before, read just after); prefill + decode logits against
   ``forward`` on the extended sequence within ``tests/test_models.py``'s
   0.15, on the rows whose compared token was routed alike in both runs
   (routing words first); prefill ms, decode ms a step, tokens/s and the
   peak memory. Training at full width, depth cut to 2 layers: 4 steps of
   ``make_train_step`` at 8 x 512 tokens (microbatches 4, remat full; B6 16
   launches a step), microbatches 4 against 1 within the reference's
   5e-3, an int8 step held against the quantizer written out by hand, one
   profiled step (wall, device busy, idle share). Then the nine smoke
   configurations on the card against the port's CPU run of the same
   parameters (forward, prefill, decode, one train step). B6 is timed at
   the prefill's dispatch shape; the kernels line's B6 entry is that
   row.

16. resilient — right after the lm phase: ``runtime.run_resilient`` over
   the same 2-layer train step at full width (8 x 512 tokens, microbatches
   4), a checkpoint every 2 steps under ``build/resilient-ckpt`` (about 21
   GB each: fp32 params and both AdamW moments; removed afterwards), the
   first try of step 3 failing with an injected ``RuntimeError``: the loop
   restores step 2 and ends at step 4 (step executions 0, 1, 2, 2, 3); B6
   16 launches each. Bytes a checkpoint, seconds a snapshot, a write and a
   restore, ms a step execution, peak memory.

17. placement — the host mesh (``launch.mesh.make_host_mesh``) on the
   card; ``Resolver.tree_shardings`` of Qwen1.5-MoE-A2.7B's parameters on
   it; the step-4 checkpoint restored to the host and placed on the card by
   ``reshard_on_load`` == the final train state, bit for bit; the MoE
   smoke's forward under ``use_resolver`` == without, bit for bit, with the
   same B6 launches and the CPU run's constrain calls.

18. dryrun — host only: ``launch.dryrun.build_cell`` records of
   Qwen1.5-MoE-A2.7B at train_4k, prefill_32k and decode_32k on the 16 x
   16 virtual mesh and train_4k under ``dp_only`` (traced on ``meta``);
   then the roofline, on the H100 constants of ``launch/dryrun.py``, of the
   lm phase's measured prefill, decode step and train step on a 1 x 1 mesh,
   beside their measured times.

Output: human-readable lines, then a JSON ``{"kernels": [...]}`` line, then
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Details
go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --only parallel

runs the device and build phases, saves the fleet phase's registry, then
the parallel phase alone: on a machine of several cards it adds the mesh
over every card to the virtual ones. It prints no kernel line, and its
details go to ``chiprun_out/chip_smoke_parallel.json``.

    python3 chip_smoke.py --only lm

runs the device and build phases, then the lm phase alone, with the
resilient, placement and dryrun phases; no kernel line, details in
``chiprun_out/chip_smoke_lm.json``.

    python3 chip_smoke.py --only kernels

runs the device and build phases, then the kernels phase (B1, B2, B3 and
C3) alone; no kernel line (its launch counts come from the serve phase),
details in ``chiprun_out/chip_smoke_kernels.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SPEC = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10"   # paper CIFAR-10
HW, C_IN, T, DEPTH, MODE = 32, 3, 4, 64, "mttfs_cont"
BUCKETS = (1, 4, 16, 64)
N_REQUESTS = 256      # the reference serve bench's default --requests
SERVE_RUNS = 5        # closed-loop runs per handle
PROFILE_WINDOWS = 5   # profiled windows per handle, 5 bucket calls each
OBS_RUNS = 4          # closed-loop runs each, tracing off and on, in turns
SEED = 0
FLEET_DIR = ROOT / "chiprun_out" / "fleet"   # the fleet's --cache-dir

# H100 SXM published peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # non-tensor-core fp32
INT8_OP_PER_S = 1979e12        # int8 tensor cores
# int32 outside the tensor cores: half the fp32 rate, as an H100 SM has 64
# INT32 lanes to 128 FP32 ones (NVIDIA H100 Tensor Core GPU Architecture
# white paper); counted like the fp32 peak, a multiply-add as two ops
INT32_OP_PER_S = FP32_FLOP_PER_S / 2

# kernel -> substrings of its CUDA kernels' names in a profiler trace
KERNEL_NAMES = {
    "fused_spike_accum": ("fused_spike_accum_encode",
                          "fused_spike_accum_gather"),
    "quant_matmul": ("quant_matmul_cluster_kernel",),
    "fused_spike_accum_sparse": ("sparse_encode_kernel", "sparse_rows_kernel",
                                 "sparse_gather_kernel"),
    "event_accum": ("event_accum_decode_kernel", "event_accum_gather_kernel"),
    "spike_compact": ("spike_compact_kernel",),
    "moe_gather": ("moe_gather_bulk_kernel", "moe_gather_warp_kernel"),
}
# B1's device work in a window of B1 calls alone: its kernels and the
# memset that zeroes its statistics
B1_DEVICE_NAMES = KERNEL_NAMES["fused_spike_accum"] + ("Memset",)
MOE_SHAPES = (  # (T, d, S, dtypes)
    (1024, 128, 512, ("float32", "bfloat16")),   # benchmarks/kernel_bench.py
    (16, 8, 12, ("float32", "bfloat16")),        # tests/test_kernels.py
    (64, 32, 50, ("float32", "bfloat16")),
    (10, 128, 40, ("float32", "bfloat16")),
    (4096, 4096, 8192, ("bfloat16",)))   # bytes-bound: 32 MB in, 64 MB out
B2_SQUARE = (256, 256, 256)   # benchmarks/kernel_bench.py's quant_matmul


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of one ``fn()`` call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, names, reps=20):
    """Mean device time per call of the kernels whose names contain one of
    ``names``, over ``reps`` calls of ``fn`` (torch.profiler): the kernel
    alone, without the host's launch cost, which the CUDA-event time of a
    short kernel includes. A window now and then comes back without some
    records: the first window in which every kernel it saw ran at least
    once a call counts; failing that in 5 windows, the fullest one does,
    and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_n = [], -1
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(n in e.key for n in names)]
        if hits and all(e.count >= reps for e in hits):
            best = hits
            break
        if sum(e.count for e in hits) > best_n:
            best, best_n = hits, sum(e.count for e in hits)
    else:
        log(f"[profiler] no window of the kernels named {names} held every "
            "call's records in 5 windows; the fullest one counts")
    total = sum(e.device_time_total for e in best)
    check(total > 0, f"the profiler saw no kernel named {names}")
    return total / 1e3 / reps


def bound(nbytes, ops, ops_per_s):
    """Least time in ms for the work: the larger of bytes and ops bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Nets and inputs
# ---------------------------------------------------------------------------

def dyadic_params(params, device):
    """The same net with every weight rounded to a multiple of 2^-8 and
    biases of 2^-4, so every fp32 sum is exact in any order; the dense
    layer's max |w| is 127 * 2^-8, which makes its int8 scale a power of
    two (exact dequant)."""
    import torch

    out = []
    for i, layer in enumerate(params):
        if not layer:
            out.append({})
            continue
        w = torch.round(layer["w"] * 256) / 256
        if i == len(params) - 1:
            w = torch.clamp(w, -127 / 256, 127 / 256)
            w[0, 0] = 127 / 256
        out.append({"w": w.to(device),
                    "b": torch.full_like(layer["b"], 0.0625).to(device)})
    return out


def stage_inputs(params, ths, cfg, images):
    """Per conv stage: (ConvPlan, occupancy (B*T, C, K2, P), weights) of the
    event-driven stages on ``images``, plus the binary-input first stage."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.aeq import phase_occupancy
    from repro_torch.core.encoding import encode_ttfs

    plan = engine.compile_plan(cfg.spec, cfg.input_hw, cfg.input_c)
    backend = engine.get_backend("queue_pallas")
    B = images.shape[0]
    stages = []
    cp0 = plan.convs[0]
    ttfs = encode_ttfs(images, cfg.T, cfg.input_theta).movedim(0, 1)
    stages.append(("conv0 (binary input)", cp0,
                   phase_occupancy(cp0.fmt, ttfs), params[0]["w"]))
    raster, analog = None, images
    with torch.inference_mode():
        for i, cp in enumerate(plan.convs):
            w, b = params[cp.index]["w"], params[cp.index]["b"]
            if raster is not None:
                stages.append((f"conv{i}", cp,
                               phase_occupancy(cp.fmt, raster), w))
            raster, _ = backend.conv_layer_batch(cp, w, b, ths[cp.index], cfg,
                                                 raster, analog)
            analog = None
    out = []
    for name, cp, occ, w in stages:
        K2, P = occ.shape[-2:]
        out.append((name, cp, occ.reshape(B * cfg.T, cp.in_c, K2, P)
                    .contiguous(), w.contiguous()))
    return out, raster


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_audit():
    """[audit]: the contract checker's traced layer on the card, the
    kernels' shared memory Python against C, graph-capture flatness."""
    import torch

    from repro_torch.audit import cli, smem

    t0 = time.perf_counter()
    report = {}
    res = cli.run(str(ROOT), device="cuda", report=report)
    check(not res.fresh, "audit: findings outside the baseline on the card: "
          + "; ".join(f.render() for f in res.fresh))
    check(not res.stale, f"audit: stale baseline entries {res.stale}")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = smem.compare_launchers(
        smem.launcher_cases(C3_GATHER + (C3_W8,), C3_B5), sm_count)
    bad = [r for r in pairs if not r["equal"]]
    check(pairs and not bad, f"audit: smem_blocks != the launcher's bytes in "
          f"{len(bad)} of {len(pairs)} cases, e.g. {bad[:2]}")
    graphs = report["graphs"]
    check(graphs and all(r["captured"] == r["eager"] for r in graphs),
          "audit: a captured graph's launches differ from the eager call's")
    serve = {r["module"].split(".")[-1] + (f"[{r['launch']}]" if r["launch"]
                                           else ""): r["python"]
             for r in pairs if r["geometry"].get("H") == 32
             and r["geometry"].get("C_out") == 32
             and r["geometry"].get("depth") == DEPTH}
    launched = {k: v["launches"] for k, v in report["traces"].items()
                if v["launches"]}
    seconds = time.perf_counter() - t0
    log(f"[audit] findings by rule {res.by_rule()} (device cuda), "
        f"{len(res.baselined)} baselined, 0 fresh, 0 stale | smem_blocks == "
        f"the compiled launcher's bytes in {len(pairs)} (kernel, launch, "
        f"geometry) pairs: every paper geometry and C3's shapes | graph "
        f"capture: {len(graphs)} (backend, bucket) plans, compile_count flat "
        f"over a second warmup, captured launches == eager in all | "
        f"{seconds:.1f} s")
    log(f"[audit]   cross-batch reductions by trace "
        f"{ {k: v['cross_batch'] for k, v in report['traces'].items()} }")
    log(f"[audit]   kernel launches in the traces {launched}; smem bytes a "
        f"block at the CIFAR-10 serve shapes (conv1, 32x32, C_out 32) "
        f"{serve}")
    return dict(by_rule=res.by_rule(), baselined=len(res.baselined),
                fresh=0, traces=report["traces"], graphs=graphs,
                smem_pairs=len(pairs), smem_serve=serve, seconds=seconds)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: "
        f"{' / '.join(smi.stdout.strip().splitlines())} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible")
    return kind, smi_line


def phase_build():
    from repro_torch.core import compile_cache
    from repro_torch.kernels import _cuda

    compile_cache.configure(str(FLEET_DIR / "kernels"))
    t0 = time.perf_counter()
    paths = _cuda.build_all()
    cache = compile_cache.stats()
    log(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc each, in parallel) into the compile cache {cache['dir']}:"
        f" {cache['misses']} misses, {cache['puts']} puts, {cache['hits']} "
        f"hits, {cache['entries']} libraries of {cache['bytes']} bytes")
    out = {"compile_cache": cache}
    for name in paths:
        build_log = _cuda.build_dir() / f"{name}.log"
        text = build_log.read_text() if build_log.exists() else ""
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        stack = [int(m) for m in re.findall(r"(\d+) bytes stack frame", text)]
        out[name] = dict(library=str(paths[name]), kernels=len(regs),
                         registers=regs, spill_bytes=sum(spills),
                         stack_bytes=max(stack, default=0))
        log(f"[build]   {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{sum(spills)}, largest stack frame {max(stack, default=0)} B")
    return out


def dropped_conv(occ, cp, w, depth):
    """The library yardstick of B1 and B3: the drop mask, the surviving
    0/1 map rebuilt in NCHW, one cuDNN conv (NCHW out)."""
    import torch.nn.functional as F

    from repro_torch.core.aeq import segment_keep

    fmt = cp.fmt
    keep = segment_keep(occ, depth)
    m = keep.reshape(-1, cp.in_c, cp.kernel, cp.kernel, fmt.n_win,
                     fmt.n_win).permute(0, 1, 4, 2, 5, 3)
    m = m.reshape(-1, cp.in_c, fmt.n_win * cp.kernel,
                  fmt.n_win * cp.kernel)[:, :, :cp.in_hw, :cp.in_hw]
    return F.conv2d(m.float(), w.permute(3, 2, 0, 1), padding=cp.kernel // 2)


def stage_work(occ, cp, depth, w, device):
    """Surviving events, scalar adds and the bytes a stage must move
    (occupancy in, weights in, fp32 charge out)."""
    from repro_torch.core.aeq import segment_keep, span_map

    keep = segment_keep(occ, depth)
    adds = int((keep * span_map(cp.fmt, cp.in_hw, device)).sum()) * cp.out_c
    nbytes = (occ.numel() * 4 + w.numel() * w.element_size()
              + occ.shape[0] * cp.in_hw * cp.in_hw * cp.out_c * 4)
    return int(keep.sum()), adds, nbytes


def phase_kernels(stages, last_raster, params, device):
    """B1 and B2 against their plain versions at the serve shapes, timed."""
    import torch

    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_pipeline as sp

    gen = torch.Generator().manual_seed(SEED + 1)
    b1_rows, b1_err = [], 0.0
    for name, cp, occ, w_gauss in stages:
        fmt = cp.fmt
        K2, P = occ.shape[-2:]
        w_dy = (torch.randint(-96, 97, tuple(w_gauss.shape), generator=gen)
                / 256.0).to(device)
        for depth in (DEPTH, 256):
            kw = dict(K=cp.kernel, n_win=fmt.n_win, depth=depth, H=cp.in_hw,
                      W=cp.in_hw)

            def kernel(w=w_gauss, kw=kw):
                return sp.fused_spike_accum_cuda(occ, w, steps=T, **kw)

            def plain(w=w_gauss, kw=kw):
                return sp.fused_spike_accum_plain(occ, w, steps=T, **kw)

            def library(w=w_gauss, depth=depth):
                return dropped_conv(occ, cp, w, depth)

            ops.reset_launch_counts()
            (got, *stats), (want, *want_stats) = kernel(), plain()
            torch.cuda.synchronize()
            launches = ops.launch_counts["fused_spike_accum"]
            check(launches == 1, f"B1 {name} depth {depth}: {launches} "
                  "launches a call")
            for s_name, g, x in zip(("ev", "ovf", "ops"), stats, want_stats):
                check(torch.equal(g, x),
                      f"B1 {name} depth {depth}: statistic {s_name} differs "
                      f"from the plain version ({g.tolist()[:4]} vs "
                      f"{x.tolist()[:4]} ...)")
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
                  f"B1 {name} depth {depth}: Gaussian max |err| {err}")
            ordered = ref.fused_spike_accum_ordered_ref(occ, w_gauss, **kw)
            check(torch.equal(got, ordered),
                  f"B1 {name} depth {depth}: Gaussian weights differ from "
                  "the (c, phase)-ordered oracle (max |err| "
                  f"{float((got - ordered).abs().max())})")
            got_dy, want_dy = kernel(w_dy)[0], plain(w_dy)[0]
            oracle = ref.fused_spike_accum_ref(occ, w_dy, **kw)
            check(torch.equal(got_dy, oracle),
                  f"B1 {name} depth {depth}: dyadic weights differ from the "
                  "scatter oracle (max |err| "
                  f"{float((got_dy - oracle).abs().max())})")
            check(torch.equal(got_dy, want_dy),
                  f"B1 {name} depth {depth}: dyadic weights not bit-exact "
                  f"(max |err| {float((got_dy - want_dy).abs().max())})")
            b1_err = max(b1_err, err)
            events, adds, nbytes = stage_work(occ, cp, depth, w_gauss, device)
            b_ms, b_by = bound(nbytes, adds, FP32_FLOP_PER_S)
            check(events == int(stats[0].sum()) and adds == int(
                stats[2].to(torch.int64).sum()),
                f"B1 {name} depth {depth}: its statistics sum to "
                f"{int(stats[0].sum())} events and {int(stats[2].sum())} "
                f"adds, the stage's work to {events} and {adds}")
            row = dict(stage=name, N=occ.shape[0], C_in=cp.in_c, hw=cp.in_hw,
                       C_out=cp.out_c, P=P, depth=depth,
                       events=events, adds=adds, bytes=nbytes,
                       dropped=int(stats[1].sum()), launches=launches,
                       max_abs_err=err, ms=time_ms(kernel),
                       device_ms=device_ms(kernel, B1_DEVICE_NAMES),
                       plain_ms=time_ms(plain), library_ms=time_ms(library),
                       bound_ms=b_ms, bound_by=b_by)
            b1_rows.append(row)
            log(f"[kernels] B1 {name:21s} N={row['N']} C_in={cp.in_c} "
                f"hw={cp.in_hw} C_out={cp.out_c} depth={depth} "
                f"events={row['events']} dropped={row['dropped']} adds={adds}"
                f" | {launches} launch, ms {row['ms']:.4f} "
                f"(device {row['device_ms']:.4f}) plain {row['plain_ms']:.4f} library {row['library_ms']:.4f}"
                f" bound {b_ms:.4f} ({b_by}) | max|err| {err:.3g} vs plain, "
                "== ordered oracle, statistics == plain")

    # B2: the output head at every bucket, on real spike counts
    w_out = params[-1]["w"]
    w_q, w_scale = quantize_symmetric(w_out, 8)
    w_q = w_q.contiguous()
    one = torch.ones((), dtype=torch.float32, device=device)
    # torch._int_mm takes M > 16 and K, N multiples of 8: the library call
    # gets the weights zero-padded to N=16 columns once (static, like the
    # weights themselves), and A zero-padded to 32 rows where M <= 16
    Kd, N = w_q.shape
    w_q_pad = torch.zeros((Kd, -(-N // 8) * 8), dtype=torch.int8,
                          device=device)
    w_q_pad[:, :N] = w_q
    counts_all = last_raster.reshape(last_raster.shape[0], T, -1).sum(1) \
        .to(torch.int8)
    b2_rows, b2_err = [], 0.0
    for M in BUCKETS:
        counts = counts_all[:M].contiguous()
        rnd = torch.randint(-128, 128, (M, w_q.shape[0]), generator=gen,
                            dtype=torch.int8).to(device)
        for a in (counts, rnd):
            got = qm.quant_matmul_cuda(a, w_q, one, w_scale)
            want = qm.quant_matmul_plain(a, w_q, one, w_scale)
            check(torch.equal(got, want),
                  f"B2 M={M}: not bit-exact vs the plain version "
                  f"(max |err| {float((got - want).abs().max())})")
            b2_err = max(b2_err, float((got - want).abs().max()))

        def kernel(a=counts):
            return qm.quant_matmul_cuda(a, w_q, one, w_scale)

        def plain(a=counts):
            return qm.quant_matmul_plain(a, w_q, one, w_scale)

        a_pad = counts
        if M <= 16:
            a_pad = torch.zeros((32, Kd), dtype=torch.int8, device=device)
            a_pad[:M] = counts

        def library(a=a_pad, M=M):
            return (torch._int_mm(a, w_q_pad)[:M, :N].float()
                    * (one * w_scale))

        check(torch.equal(library(), qm.quant_matmul_cuda(counts, w_q, one,
                                                          w_scale)),
              f"B2 M={M}: padded torch._int_mm differs from the kernel")
        library_note = (f"torch._int_mm on A {tuple(a_pad.shape)} x W "
                        f"{tuple(w_q_pad.shape)} zero-padded, sliced to "
                        f"({M}, {N}), same dequant")
        b2_rows.append(b2_row(M, Kd, N, kernel, plain, library, library_note,
                              b2_err))

    # B2 at kernel_bench's square shape, where the tensor cores matter
    Ms, Ks, Ns = B2_SQUARE
    a_sq = torch.randint(-128, 128, (Ms, Ks), generator=gen,
                         dtype=torch.int8).to(device)
    b_sq = torch.randint(-128, 128, (Ks, Ns), generator=gen,
                         dtype=torch.int8).to(device)
    sa = torch.tensor(0.013, device=device)
    got = qm.quant_matmul_cuda(a_sq, b_sq, sa, w_scale)
    want = qm.quant_matmul_plain(a_sq, b_sq, sa, w_scale)
    lib = torch._int_mm(a_sq, b_sq).float() * (sa * w_scale)
    check(torch.equal(got, want) and torch.equal(got, lib),
          f"B2 {B2_SQUARE}: not bit-exact vs the plain version and "
          f"torch._int_mm (max |err| {float((got - want).abs().max())})")
    b2_rows.append(b2_row(
        Ms, Ks, Ns, lambda: qm.quant_matmul_cuda(a_sq, b_sq, sa, w_scale),
        lambda: qm.quant_matmul_plain(a_sq, b_sq, sa, w_scale),
        lambda: torch._int_mm(a_sq, b_sq).float() * (sa * w_scale),
        "torch._int_mm, same dequant", b2_err))
    return b1_rows, b1_err, b2_rows, b2_err


def b2_row(M, K, N, kernel, plain, library, library_note, err):
    """B2's times at one shape: CUDA events and device (profiler) ms of the
    kernel, its plain version's and the library call's, and its bound."""
    nbytes = M * K + K * N + M * N * 4 + 8
    b_ms, b_by = bound(nbytes, 2 * M * K * N, INT8_OP_PER_S)
    row = dict(M=M, K=K, N=N, ms=time_ms(kernel),
               device_ms=device_ms(kernel, KERNEL_NAMES["quant_matmul"]),
               plain_ms=time_ms(plain), library_ms=time_ms(library),
               library_device_ms=device_ms(library, ("",)),
               library_note=library_note, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err)
    log(f"[kernels] B2 M={M:3d} K={K} N={N} | ms {row['ms']:.4f} (device "
        f"{row['device_ms']:.4f}) plain {row['plain_ms']:.4f} library "
        f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f}; "
        f"{library_note}) bound {b_ms:.6f} ({b_by}) | bit-exact")
    return row


def phase_b3(stages, device):
    """B3 against its plain version at the serve shapes (N = 64*4 rows,
    depth 64, the Gaussian net's real occupancy), fp32 and weight_bits=8,
    plus a ragged case; timed beside B1, the plain version and cuDNN."""
    import torch

    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_pipeline as sp
    from repro_torch.kernels import spike_sparse as ss

    gen = torch.Generator().manual_seed(SEED + 2)
    rows, err_max = [], 0.0
    for name, cp, occ, w_gauss in stages:
        fmt = cp.fmt
        N = occ.shape[0]
        w_dy = (torch.randint(-96, 97, tuple(w_gauss.shape), generator=gen)
                / 256.0).to(device)
        kw = dict(K=cp.kernel, n_win=fmt.n_win, depth=DEPTH, H=cp.in_hw,
                  W=cp.in_hw)

        def e_cap_of(o):
            kept = ss.kept_event_count(o, depth=DEPTH).item()
            return ss.event_bucket(kept, ss.max_kept_events(o.shape, DEPTH))

        e_cap = e_cap_of(occ)

        def kernel(w=w_gauss, wb=None, o=occ, n_rows=None):
            return ss.fused_spike_accum_sparse_cuda(
                o, w, weight_bits=wb, n_rows=n_rows, **kw)

        def plain(w=w_gauss, wb=None, o=occ, e_cap=e_cap):
            return ss.fused_spike_accum_sparse_plain(
                o, w, e_cap=e_cap, weight_bits=wb, **kw)

        def b1(w=w_gauss, o=occ):
            return sp.fused_spike_accum_cuda(o, w, **kw)[0]

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
              f"B3 {name}: Gaussian max |err| {err} vs the plain version")
        check(torch.equal(got, b1()),
              f"B3 {name}: Gaussian weights differ from B1 (max |err| "
              f"{float((got - b1()).abs().max())})")
        ordered = ref.fused_spike_accum_ordered_ref(occ, w_gauss, **kw)
        check(torch.equal(got, ordered),
              f"B3 {name}: Gaussian weights differ from the (c, phase)-"
              "ordered oracle (max |err| "
              f"{float((got - ordered).abs().max())})")
        got_dy, want_dy = kernel(w_dy), plain(w_dy)
        check(torch.equal(got_dy, want_dy),
              f"B3 {name}: dyadic weights not bit-exact (max |err| "
              f"{float((got_dy - want_dy).abs().max())})")
        got_q, want_q = kernel(wb=8), plain(wb=8)
        check(torch.equal(got_q, want_q)
              and torch.equal(got_q, ref.fused_spike_accum_quant_ref(
                  occ, w_gauss, weight_bits=8, **kw)),
              f"B3 {name}: weight_bits=8 not bit-exact (max |err| "
              f"{float((got_q - want_q).abs().max())})")
        err_max = max(err_max, err)

        # ragged: only every 8th row keeps its events; n_rows = active rows
        keep_rows = torch.zeros(N, dtype=torch.bool, device=device)
        keep_rows[::8] = True
        occ_r = (occ * keep_rows[:, None, None, None]).contiguous()
        n_act = int((occ_r > 0).flatten(1).any(1).sum())
        got_r = kernel(w_dy, o=occ_r, n_rows=n_act)
        want_r = plain(w_dy, o=occ_r, e_cap=e_cap_of(occ_r))
        check(n_act < N and torch.equal(got_r, want_r),
              f"B3 {name}: ragged n_rows={n_act} of {N} not bit-exact")

        # w8's yardstick: cuDNN on the integers in fp32 (TF32 off), then the
        # scale: every partial sum is an integer below 9*128*127 < 2^24, so
        # exact in any order, and the one multiply rounds as B3's does
        w_q, w_scale = quantize_symmetric(w_gauss, 8)
        w_int = w_q.float()

        def library_q(w=w_int, scale=w_scale):
            return dropped_conv(occ, cp, w, DEPTH) * scale

        lib_q = library_q().permute(0, 2, 3, 1)
        check(torch.equal(lib_q, got_q),
              f"B3 {name}: the w8 yardstick differs from B3 w8 (max |err| "
              f"{float((lib_q - got_q).abs().max())})")

        events, adds, nbytes = stage_work(occ, cp, DEPTH, w_gauss, device)
        ev_r, adds_r, bytes_r = stage_work(occ_r, cp, DEPTH, w_gauss, device)
        b_ms, b_by = bound(nbytes, adds, FP32_FLOP_PER_S)
        bq_ms, bq_by = bound(nbytes, adds, INT32_OP_PER_S)
        br_ms, br_by = bound(bytes_r, adds_r, FP32_FLOP_PER_S)
        row = dict(
            stage=name, N=N, C_in=cp.in_c, hw=cp.in_hw, C_out=cp.out_c,
            depth=DEPTH, events=events, adds=adds, bytes=nbytes, e_cap=e_cap,
            max_abs_err=err, ms=time_ms(kernel),
            device_ms=device_ms(kernel,
                                KERNEL_NAMES["fused_spike_accum_sparse"]),
            plain_ms=time_ms(plain),
            library_ms=time_ms(lambda: dropped_conv(occ, cp, w_gauss, DEPTH)),
            b1_ms=time_ms(b1), bound_ms=b_ms, bound_by=b_by,
            w8_ms=time_ms(lambda: kernel(wb=8)),
            w8_device_ms=device_ms(lambda: kernel(wb=8),
                                   KERNEL_NAMES["fused_spike_accum_sparse"]),
            w8_plain_ms=time_ms(lambda: plain(wb=8)),
            w8_library_ms=time_ms(library_q), w8_bound_ms=bq_ms,
            w8_bound_by=bq_by,
            ragged_rows=n_act, ragged_events=ev_r,
            ragged_ms=time_ms(lambda: kernel(o=occ_r, n_rows=n_act)),
            ragged_b1_ms=time_ms(lambda: b1(o=occ_r)),
            ragged_bound_ms=br_ms, ragged_bound_by=br_by)
        rows.append(row)
        log(f"[kernels] B3 {name:21s} N={N} C_in={cp.in_c} hw={cp.in_hw} "
            f"C_out={cp.out_c} events={events} | fp32 ms {row['ms']:.4f} "
            f"(device {row['device_ms']:.4f}; B1 {row['b1_ms']:.4f}) plain {row['plain_ms']:.4f} library "
            f"{row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}) | w8 ms "
            f"{row['w8_ms']:.4f} (device {row['w8_device_ms']:.4f}) plain {row['w8_plain_ms']:.4f} library "
            f"{row['w8_library_ms']:.4f} bound {bq_ms:.4f} ({bq_by}) | "
            f"ragged {n_act}/{N} rows ms {row['ragged_ms']:.4f} (B1 "
            f"{row['ragged_b1_ms']:.4f}) | max|err| {err:.3g}, == B1 and "
            "the ordered oracle, dyadic/w8/ragged bit-exact, w8 library "
            "equal")
    return rows, err_max


# C3: shapes past the old limits of B1, B3, B4 (the staged kept bits of a
# whole map row, K in {1, 3, 5, 7} only) and B5 (depth <= 58,103)
C3_GATHER = (  # (hw, C_in, C_out, K, rows, depth)
    (128, 4, 40, 3, 2, 16), (512, 3, 32, 3, 2, 64),
    (32, 3, 40, 9, 3, 16), (32, 3, 40, 11, 3, 16))
C3_W8 = (14, 2720, 32, 7, 2, 4)   # K*K*C_in*127 = 16,925,360 > 2^24
C3_B5 = ((6, 11, 65536), (5, 1, 65536))   # (rows, n_win, depth)


def phase_c3(device):
    """C3 on the card: B1, B3 and B4 at maps past the old staged-bits limit
    (K = 3, W = 128 and 512) and at K = 9 and 11 (the rolled gather), B3 w8
    past 2^24 (int32 sums), B5 at depth 65,536: every result bit-exact
    against its oracle (the (c, phase)-ordered one for B1, B3 and B4 in fp32
    and B4 in bf16 and on repeated words; the quantized one for B3 w8; the
    plain version for B5), B1 also within 1e-4 of its plain version."""
    import numpy as np
    import torch

    from repro_torch.core.aeq import aeq_from_raster_batch, phase_occupancy
    from repro_torch.core.encoding import make_format
    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_compact as sc
    from repro_torch.kernels import spike_pipeline as sp
    from repro_torch.kernels import spike_sparse as ss

    rng = np.random.default_rng(SEED + 17)

    def gauss(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(device)

    def spikes(*shape, p=0.25):
        return torch.from_numpy((rng.random(shape) < p).astype(np.float32)) \
            .to(device)

    rows_out = []
    for hw, c_in, c_out, K, n, depth in C3_GATHER:
        fmt = make_format(hw, K)
        kw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
        occ = phase_occupancy(fmt, spikes(n, hw, hw, c_in)).contiguous()
        w = gauss(K, K, c_in, c_out)
        want = ref.fused_spike_accum_ordered_ref(occ, w, **kw)
        b1, *b1_stats = sp.fused_spike_accum_cuda(occ, w, **kw)
        b3 = ss.fused_spike_accum_sparse_cuda(occ, w, **kw)
        b3q = ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=8, **kw)
        torch.cuda.synchronize()
        tag = f"K={K} W={hw} C_in={c_in} C_out={c_out} rows={n}"
        check(torch.equal(b1, want), f"C3 B1 {tag}: differs from the ordered "
              f"oracle (max |err| {float((b1 - want).abs().max())})")
        check(torch.equal(b3, want), f"C3 B3 {tag}: differs from the ordered "
              "oracle")
        check(torch.equal(b3q, ref.fused_spike_accum_quant_ref(
            occ, w, weight_bits=8, **kw)),
            f"C3 B3 w8 {tag}: differs from the quantized oracle")
        plain, *plain_stats = sp.fused_spike_accum_plain(occ, w, **kw)
        err = float((b1 - plain).abs().max())
        check(torch.allclose(b1, plain, atol=1e-4, rtol=1e-4),
              f"C3 B1 {tag}: max |err| {err} vs the plain version")
        check(all(torch.equal(g, x) for g, x in zip(b1_stats, plain_stats)),
              f"C3 B1 {tag}: statistics differ from the plain version")

        # B4 on a step's slice of real queues (B5 wrote them), fp32 and
        # bf16, then on queues that repeat positions
        raster = spikes(n, 2, c_in, hw, hw, p=0.2)
        q = aeq_from_raster_batch(fmt, raster, depth)
        words, counts = q.words[:, 1], q.counts[:, 1]
        occ_t = phase_occupancy(fmt, raster[:, 1].permute(0, 2, 3, 1))
        vm = gauss(n, hw, hw, c_out)
        kw4 = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
        b4 = ea.event_accum_cuda(words, counts, w, vm, **kw4)
        torch.cuda.synchronize()
        check(torch.equal(b4, ref.fused_spike_accum_ordered_ref(
            occ_t, w, init=vm, **kw)),
            f"C3 B4 {tag}: differs from the ordered oracle from the membrane")
        w16, vm16 = w.bfloat16(), vm.bfloat16()
        check(torch.equal(
            ea.event_accum_cuda(words, counts, w16, vm16, **kw4),
            ref.fused_spike_accum_ordered_ref(occ_t, w16, init=vm16, **kw)),
            f"C3 B4 bf16 {tag}: differs from the ordered oracle")
        D = words.shape[-1]
        wr = words[..., torch.arange(D, device=device) // 2].contiguous()
        cr = torch.clamp(counts * 2, max=D).contiguous()
        mult = ea.event_mult_plain(wr, cr, n_win=fmt.n_win,
                                   bits=fmt.bits_coord)
        check(torch.equal(
            ea.event_accum_cuda(wr, cr, w, vm, **kw4),
            ref.fused_spike_accum_ordered_ref(
                mult, w, init=vm, multiplicity=True,
                **{**kw, "depth": fmt.n_win ** 2})),
            f"C3 B4 repeats {tag}: differs from the ordered oracle on the "
            "multiplicities")

        def k1(occ=occ, w=w, kw=kw):
            return sp.fused_spike_accum_cuda(occ, w, **kw)

        def k4(words=words, counts=counts, w=w, vm=vm, kw4=kw4):
            return ea.event_accum_cuda(words, counts, w, vm, **kw4)

        row = dict(hw=hw, C_in=c_in, C_out=c_out, K=K, rows=n, depth=depth,
                   b1_ms=time_ms(k1),
                   b1_device_ms=device_ms(k1, B1_DEVICE_NAMES),
                   b4_ms=time_ms(k4),
                   b4_device_ms=device_ms(k4, KERNEL_NAMES["event_accum"]),
                   b1_plain_max_abs_err=err,
                   route="unrolled" if K in sp.UNROLLED_K else "rolled",
                   smem_bytes=(sp.gather_smem(K, fmt.n_win, hw, hw)
                               if K in sp.UNROLLED_K else 0))
        rows_out.append(row)
        log(f"[c3] {tag} depth={depth} ({row['route']} gather, "
            f"{row['smem_bytes']} B shared a block): B1, B3 == ordered "
            f"oracle, B3 w8 == quantized oracle, B4 fp32/bf16/repeats == "
            f"ordered oracle | B1 ms {row['b1_ms']:.4f} (device "
            f"{row['b1_device_ms']:.4f}), B4 ms {row['b4_ms']:.4f} (device "
            f"{row['b4_device_ms']:.4f}) | B1 max|err| {err:.3g} vs plain")

    # B3's int path past 2^24: int32 sums
    hw, c_in, c_out, K, n, depth = C3_W8
    fmt = make_format(hw, K)
    check(not ss.int_sums_fit_fp32(K, c_in), "C3 w8 shape fits fp32 sums")
    kw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    occ = phase_occupancy(fmt, spikes(n, hw, hw, c_in)).contiguous()
    w = gauss(K, K, c_in, c_out)

    def kq(occ=occ, w=w, kw=kw):
        return ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=8, **kw)

    got = kq()
    torch.cuda.synchronize()
    check(torch.equal(got, ref.fused_spike_accum_quant_ref(
        occ, w, weight_bits=8, **kw)),
        f"C3 B3 w8 K={K} C_in={c_in}: differs from the quantized oracle")
    w8 = dict(hw=hw, C_in=c_in, C_out=c_out, K=K, rows=n, depth=depth,
              ms=time_ms(kq),
              device_ms=device_ms(kq,
                                  KERNEL_NAMES["fused_spike_accum_sparse"]))
    log(f"[c3] B3 w8 K={K} W={hw} C_in={c_in} (K*K*C_in*127 = "
        f"{K * K * c_in * 127} >= 2^24: int32 sums) == quantized oracle | ms "
        f"{w8['ms']:.4f} (device {w8['device_ms']:.4f})")

    # B5 past depth 58,103: rows written in place
    b5 = []
    for R, n_win, depth in C3_B5:
        fmt = make_format(n_win, 1)
        occ = (spikes(R, n_win * n_win, p=0.5) > 0).to(torch.int32)
        kw5 = dict(n_win=n_win, bits=fmt.bits_coord, depth=depth,
                   invalid=fmt.invalid_word)
        got = sc.spike_compact_cuda(occ, **kw5)
        want = sc.spike_compact_plain(occ, **kw5)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"C3 B5 rows={R} P={n_win * n_win} depth={depth}: differs from "
              "the plain version")
        b5.append(dict(rows=R, P=n_win * n_win, depth=depth,
                       ms=time_ms(lambda occ=occ, kw5=kw5:
                                  sc.spike_compact_cuda(occ, **kw5))))
        log(f"[c3] B5 rows={R} P={n_win * n_win} depth={depth} == plain "
            f"version | ms {b5[-1]['ms']:.4f}")
    return dict(gather=rows_out, b3_w8=w8, b5=b5)


def spread(values):
    """min / median / max of a list of numbers."""
    import numpy as np

    v = np.asarray(values, np.float64)
    return dict(min=float(v.min()), median=float(np.median(v)),
                max=float(v.max()))


def fmt_spread(d, f="{:.3f}"):
    return (f"{f.format(d['median'])} (min {f.format(d['min'])}, max "
            f"{f.format(d['max'])})")


def _stats_equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _graph_launches(handles, before):
    """Kernel launches that graph replays made since ``before`` (bucket ->
    replays per handle): each bucket's captured launches times its
    replays."""
    out = {}
    for name, h in handles.items():
        for b, n in h.replay_count.items():
            n -= before[name].get(b, 0)
            for k, v in h.plan_launches[b].items():
                out[k] = out.get(k, 0) + v * n
    return out


def phase_serve(params, device, kind):
    """Serve the full-width net through the port, one captured CUDA graph
    per bucket: launch gates (captured launches x replays), replay == eager,
    energy metering, the mask contract, the closed and the open loop."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.kernels import ops
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime
    from repro_torch.serve import bench
    from repro_torch.study import StatsRecord, price_record

    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    images, _ = make_cifar_like(N_REQUESTS, seed=SEED + 7)

    def reserved_now():
        """Device memory the caching allocator holds once its free blocks
        are returned: a captured graph's private pool stays reserved."""
        gc.collect()  # also the earlier phases' profiler records
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    reserved0 = reserved_now()

    ops.reset_launch_counts()                      # the main-path window:
    registry = ModelRegistry(capacity=4, device=device)   # capture, serve
    handles = {
        "cifar10-fp32": registry.register("cifar10-fp32", params, th, cfg),
        "cifar10-w8": registry.register("cifar10-w8", params, th,
                                        cfg._replace(weight_bits=8)),
    }
    t0 = time.perf_counter()
    for h in handles.values():
        h.warmup(BUCKETS)                          # captures, 2nd pass flat
        check(h.compile_count == len(BUCKETS),
              f"{h.name}: {h.compile_count} captures for buckets {BUCKETS}")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    reserved = reserved_now() - reserved0
    captured = {n: {b: dict(h.plan_launches[b]) for b in BUCKETS}
                for n, h in handles.items()}
    for name, per_bucket in captured.items():
        for b, got in per_bucket.items():
            want = {"fused_spike_accum": 6,
                    "quant_matmul": int(name.endswith("w8"))}
            check(all(got[k] == v for k, v in want.items())
                  and sum(got.values()) == sum(want.values()),
                  f"{name} bucket {b}: the graph captured {got}, expected "
                  f"{want}")
    log(f"[serve] warmup of {len(handles)} handles x buckets {BUCKETS} "
        f"(eager run, capture, two passes): {warmup_s:.2f} s; the graphs, "
        f"their static buffers and the params reserve "
        f"{reserved / 2 ** 20:.1f} MiB of device memory "
        f"(torch.cuda.memory_reserved after warmup, free cache emptied, "
        f"less the same before registration); each "
        f"bucket's graph holds {_nonzero(captured['cifar10-w8'][64])} "
        "launches (w8)")

    runtime = ServeRuntime(registry, BucketPolicy(BUCKETS))
    replays0 = {n: dict(h.replay_count) for n, h in handles.items()}
    results = {}
    for name in handles:
        for run in range(SERVE_RUNS):              # closed loop, as the
            batches0 = runtime.n_batches           # reference bench runs it
            res = bench.closed_loop(runtime, name, images)
            results[(name, run)] = dict(
                result=res, batches=runtime.n_batches - batches0)
    counted = dict(ops.launch_counts)              # read right after
    replayed = _graph_launches(handles, replays0)
    log(f"[serve] launch counters in the serve window (eager warmups and "
        f"captures; replays run no wrapper): {_nonzero(counted)}; replayed "
        f"launches (captured x replays, closed loop): {_nonzero(replayed)}")
    n_batches = sum(r["batches"] for r in results.values())
    w8_batches = sum(r["batches"] for (name, _), r in results.items()
                     if name == "cifar10-w8")
    check(counted["fused_spike_accum"] > 0 and counted["quant_matmul"] > 0,
          f"a serve kernel never launched in the serve window: {counted}")
    check(replayed.get("fused_spike_accum", 0) == 6 * n_batches,
          f"B1 replayed {replayed.get('fused_spike_accum', 0)} launches for "
          f"{n_batches} buckets (expected 6 per bucket)")
    check(replayed.get("quant_matmul", 0) == w8_batches,
          f"B2 replayed {replayed.get('quant_matmul', 0)} launches for "
          f"{w8_batches} w8 buckets (expected 1 each)")

    summary = {}
    for name, h in handles.items():
        runs = []
        for run in range(SERVE_RUNS):
            res = results[(name, run)]["result"]
            resp = res.responses
            check(res.n_requests == N_REQUESTS,
                  f"{name}: {res.n_requests} responses")
            logits = np.stack([x.logits for x in resp])
            check(logits.shape == (N_REQUESTS, 10)
                  and np.isfinite(logits).all(),
                  f"{name}: logits not finite or of shape {logits.shape}")
            record = StatsRecord(*(np.concatenate([getattr(x.stats, f)
                                                   for x in resp])
                                   for f in StatsRecord._fields))
            one_shot = price_record(record, input_hw=HW).total_j.numpy()
            served = bench.energy_array(resp)
            check(np.array_equal(served, one_shot)
                  and served.sum() == one_shot.sum(),
                  f"{name}: per-request energies differ from one-shot "
                  "pricing")
            hist = {}
            for x in resp:
                hist[x.bucket] = hist.get(x.bucket, 0) + 1
            runs.append(dict(
                batches=results[(name, run)]["batches"],
                requests_per_s=res.throughput_rps,
                latency_ms_p50=res.latency_p50_s * 1e3,
                latency_ms_p99=res.latency_p99_s * 1e3,
                step_ms=[x.step_total_s * 1e3 for x in resp],
                requests_by_bucket=hist))
        parity = bench.verify_energy_parity(runtime, name, images,
                                            results[(name, 0)]["result"]
                                            .responses)
        check(parity["elementwise_bitexact"] and parity["sum_bitexact"],
              f"{name}: served energies differ from one-shot infer_batch + "
              f"price_record: {parity}")
        s = dict(requests=N_REQUESTS, runs=runs,
                 requests_per_s=spread([x["requests_per_s"] for x in runs]),
                 latency_ms_p50=spread([x["latency_ms_p50"] for x in runs]),
                 latency_ms_p99=spread([x["latency_ms_p99"] for x in runs]),
                 step_ms=spread([v for x in runs for v in x["step_ms"]]),
                 events_per_layer=record.events_in.mean(0).tolist(),
                 spikes_per_layer=record.spikes_out.mean(0).tolist(),
                 adds_per_layer=record.add_ops.mean(0).tolist(),
                 overflow_per_request=float(record.overflow.mean()),
                 energy_j_sum=float(served.sum()), energy_parity=parity,
                 preds=np.bincount([x.pred for x in resp],
                                   minlength=10).tolist())
        summary[name] = s
        log(f"[serve] {name} on {kind}, closed loop through graph replays "
            f"({N_REQUESTS} requests submitted, then drained; {SERVE_RUNS} "
            f"runs; buckets {runs[-1]['requests_by_bucket']}): req/s "
            f"{fmt_spread(s['requests_per_s'], '{:.1f}')} | request latency "
            f"p50 {fmt_spread(s['latency_ms_p50'])} ms, p99 "
            f"{fmt_spread(s['latency_ms_p99'])} ms | step "
            f"{fmt_spread(s['step_ms'])} ms | energy sum "
            f"{s['energy_j_sum']:.6g} J (pricing model) == one-shot "
            "price_record and infer_batch + price_record")
        log(f"[serve]   mean per request: events_in "
            f"{[round(v, 1) for v in s['events_per_layer']]} spikes_out "
            f"{[round(v, 1) for v in s['spikes_per_layer']]} overflow "
            f"{s['overflow_per_request']:.1f}")

    # partial load: the reference bench's open loop (Poisson arrivals on a
    # virtual clock, measured service times) at 1/4 and 1/2 of this handle's
    # median closed-loop rate
    open_runs = {}
    for name in handles:
        rate = summary[name]["requests_per_s"]["median"]
        for frac in (0.25, 0.5):
            res = bench.open_loop(ServeRuntime(registry, BucketPolicy(BUCKETS)),
                                  name, images, rate_rps=rate * frac,
                                  seed=SEED)
            check(res.n_requests == N_REQUESTS,
                  f"{name} open loop: {res.n_requests} responses")
            open_runs[f"{name} @{frac}"] = o = dict(
                rate_rps=rate * frac, requests_per_s=res.throughput_rps,
                latency_ms_p50=res.latency_p50_s * 1e3,
                latency_ms_p95=res.latency_p95_s * 1e3,
                latency_ms_p99=res.latency_p99_s * 1e3,
                virtual_s=res.wall_s, bucket_histogram=res.bucket_histogram)
            log(f"[serve] {name} open loop at {frac} x {rate:.1f} = "
                f"{rate * frac:.1f} req/s (Poisson, virtual clock): latency "
                f"p50 {o['latency_ms_p50']:.3f} ms, p99 "
                f"{o['latency_ms_p99']:.3f} ms | served "
                f"{o['requests_per_s']:.1f} req/s | batches by bucket "
                f"{o['bucket_histogram']}")

    # replay == the eager engine call, and the mask contract, per bucket on
    # every handle (Gaussian and dyadic): a full bucket, and a partly
    # filled one (n = b//2 + 1 rows, the rest other images) against the
    # eager call on its n rows
    dy = dyadic_params(params, device)
    dyh = {
        "dyadic-fp32": registry.register("dyadic-fp32", dy, th, cfg),
        "dyadic-w8": registry.register("dyadic-w8", dy, th,
                                       cfg._replace(weight_bits=8)),
    }
    mask_imgs, _ = make_cifar_like(max(BUCKETS), seed=SEED + 11)
    imgs_dy = (np.round(mask_imgs * 256) / 256).astype(np.float32)
    mask = {}
    for name, h in {**handles, **dyh}.items():
        src = imgs_dy if name.startswith("dyadic") else mask_imgs
        for b in BUCKETS:
            for n in sorted({b, b // 2 + 1}):
                lr, sr = h.run_bucket(src[:b], n)  # padded when n < b
                le, se = engine.infer_batch(h.params, h.thresholds, h.cfg,
                                            src[:n], backend=h.backend,
                                            device=device)
                same = torch.equal(lr, le) and _stats_equal(sr, se)
                mask[f"{name} B={b} n={n}"] = dict(
                    bit_exact=same,
                    max_abs_logit_diff=float((lr - le).abs().max()))
                check(same, f"{name} bucket {b}, {n} valid: the replay "
                      f"differs from the eager call on {n} rows (max |logit "
                      f"diff| {float((lr - le).abs().max())})")
    log(f"[serve] graph replay == eager infer_batch: {len(mask)}/{len(mask)}"
        " (handle, bucket, valid rows) cases bit-exact in logits and all "
        "five stats (4 handles x buckets x full and partly filled)")

    # the kernels against the port's CPU run (plain versions), small input
    agree = {}
    for name, h in dyh.items():
        small = imgs_dy[:3]
        lg, sg = engine.infer_batch(h.params, h.thresholds, h.cfg, small,
                                    backend="queue_pallas", device=device)
        lc, sc = engine.infer_batch([{k: v.cpu() for k, v in p.items()}
                                     for p in h.params],
                                    [t.cpu() for t in h.thresholds], h.cfg,
                                    small, backend="queue_pallas",
                                    device="cpu")
        same = torch.equal(lg.cpu(), lc) and _stats_equal(
            [s.cpu() for s in sg], sc)
        check(same, f"{name}: GPU kernels disagree with the CPU plain run "
              f"(max |logit diff| {float((lg.cpu() - lc).abs().max())})")
        agree[name] = same
    log(f"[serve] GPU == CPU plain run on 3 dyadic images: {agree}")
    return dict(closed=summary, open=open_runs, warmup_s=warmup_s,
                graphs_reserved_bytes=reserved, captured=captured,
                launch_counters=counted), replayed, mask


def profile_window(run, reps=5):
    """Wall time (host clock) and device time by kernel (torch.profiler) of
    the same ``reps`` calls of ``run``, which must end in a device
    synchronize; an unprofiled window of ``reps`` calls runs first. One
    stream, so kernel times add up without overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    bare_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []  # device-side events only: the kernels and copies
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.device_time_total / 1e3 / reps, e.count // reps,
                         e.key))
    rows.sort(reverse=True)
    check(rows, "the profiler saw no device time")
    busy_ms = sum(r[0] for r in rows)
    calls = {}  # launches per call of the port's kernels, by name
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for n in ("fused_spike_accum_gather", "quant_matmul",
                      "sparse_gather_kernel", "event_accum_gather_kernel",
                      "spike_compact_kernel"):
                if n in e.key:
                    calls[n] = calls.get(n, 0) + e.count / reps
    return dict(
        unprofiled_wall_ms=bare_ms, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms, port_kernel_calls=calls,
        device_ops=sum(r[1] for r in rows),
        port_kernels_device_ms={
            k: sum(r[0] for r in rows if any(n in r[2] for n in names))
            for k, names in KERNEL_NAMES.items()},
        top=[dict(ms=r[0], calls=r[1], name=r[2][:90]) for r in rows[:12]])


WINDOW_KEYS = ("unprofiled_wall_ms", "wall_ms", "device_busy_ms",
               "idle_share")


def log_windows(tag, name, windows, kind, reps=5):
    o = {k: spread([w[k] for w in windows]) for k in WINDOW_KEYS}
    log(f"[{tag}] {name} bucket 64 on {kind}, {len(windows)} windows x "
        f"{reps} calls, median (min, max): wall {fmt_spread(o['wall_ms'])} "
        f"ms, device busy {fmt_spread(o['device_busy_ms'])} ms in "
        f"{windows[-1]['device_ops']} device ops, idle share "
        f"{fmt_spread(o['idle_share'])} | unprofiled wall "
        f"{fmt_spread(o['unprofiled_wall_ms'])} ms | device ms of the "
        f"port's kernels (last window): "
        f"{windows[-1]['port_kernels_device_ms']}")
    for r in windows[-1]["top"]:
        log(f"[{tag}]   {r['ms']:9.4f} ms  x{r['calls']:<4d} {r['name']}")
    return o


def phase_sparse(params, ths, cfg, images, device, kind):
    """The queue_sparse path on the full-width net at bucket 64: launches
    in its own window, parity with queue_pallas and queue_ref, the mask
    contract, and profiled windows beside queue_pallas."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import ops

    dy = dyadic_params(params, device)
    imgs_dy = torch.round(images * 256) / 256
    cfg_bin = cfg._replace(input_mode="binary")
    cfg_w8 = cfg._replace(weight_bits=8)
    runs = {  # name -> (params, config, images)
        "gauss-fp32": (params, cfg, images),
        "gauss-w8": (params, cfg_w8, images),
        "dyadic-fp32": (dy, cfg, imgs_dy),
        "dyadic-w8": (dy, cfg_w8, imgs_dy),
        "dyadic-fp32-binary": (dy, cfg_bin, imgs_dy),
    }

    def infer(name, backend, imgs=None):
        p, c, im = runs[name]
        return engine.infer_batch(p, ths, c, im if imgs is None else imgs,
                                  backend=backend, device=device)

    ops.reset_launch_counts()                      # the main-path window
    out = {name: infer(name, "queue_sparse") for name in runs}
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)             # read right after
    log(f"[sparse] launches in the queue_sparse window "
        f"({len(runs)} calls): {launches}")
    check(launches["fused_spike_accum_sparse"] == 6 * 4 + 7,
          f"B3 launched {launches['fused_spike_accum_sparse']} times "
          "(expected 6 per analog call, 7 per binary call: 31)")
    check(launches["fused_spike_accum"] == 0, "B1 ran on queue_sparse")
    check(launches["quant_matmul"] == 2,
          f"B2 launched {launches['quant_matmul']} times (expected once per "
          "w8 call: 2)")

    parity = {}
    for name, (lg, st) in out.items():
        check(lg.shape == (images.shape[0], 10)
              and bool(torch.isfinite(lg).all()),
              f"{name}: logits not finite or of shape {tuple(lg.shape)}")
        anchors = ["queue_ref"]
        if runs[name][1].weight_bits is None:
            anchors.append("queue_pallas")
        for be in anchors:
            la, sa = infer(name, be)
            same = torch.equal(lg, la) and _stats_equal(st, sa)
            parity[f"{name} vs {be}"] = dict(
                bit_exact=same, stats_equal=_stats_equal(st, sa),
                max_abs_logit_diff=float((lg - la).abs().max()))
            # held: everything but fp32 Gaussian against queue_ref, whose
            # oracle adds with atomics on the card
            if not (name == "gauss-fp32" and be == "queue_ref"):
                check(same, f"queue_sparse {name} differs from {be} (max "
                      f"|logit diff| {parity[f'{name} vs {be}']})")
    for k, v in parity.items():
        log(f"[sparse] {k}: " + ("bit-exact" if v["bit_exact"] else
            f"max |logit diff| {v['max_abs_logit_diff']:.3g}, stats equal "
            f"{v['stats_equal']} (reported, not held)"))

    mask = {}
    n = images.shape[0] // 2 + 1                   # 33 of 64
    for name in ("gauss-fp32", "gauss-w8"):
        p, c, im = runs[name]
        lp, sp_ = engine.infer_batch_masked(p, ths, c, im, n,
                                            backend="queue_sparse",
                                            device=device)
        lu, su = engine.infer_batch(p, ths, c, im[:n],
                                    backend="queue_sparse", device=device)
        same = torch.equal(lp, lu) and _stats_equal(sp_, su)
        mask[name] = same
        check(same, f"queue_sparse mask contract broken on {name}: max "
              f"|logit diff| {float((lp - lu).abs().max())}")
    log(f"[sparse] padded (n={n} of {images.shape[0]}) == unpadded: {mask}")

    def call(name, backend):
        def run():
            infer(name, backend)
            torch.cuda.synchronize()
        return run

    windows = {}
    for name in ("gauss-fp32", "gauss-w8"):
        calls = {be: call(name, be) for be in ("queue_pallas",
                                               "queue_sparse")}
        for be in calls:
            calls[be]()                            # warm
        for i in range(PROFILE_WINDOWS):           # in turns
            order = list(calls) if i % 2 == 0 else list(calls)[::-1]
            for be in order:
                windows.setdefault(f"{name} {be}", []).append(
                    profile_window(calls[be]))
    summary = {k: dict(windows=w, **log_windows("sparse", k, w, kind))
               for k, w in windows.items()}
    return dict(launches=launches, parity=parity, mask_contract=mask,
                profile=summary)


def accum_library(words, counts, w, vm, cp):
    """The library yardstick of B4: the live slots scattered into a dense
    (N, C, H, W) spike map, one cuDNN conv, plus v_mem. A live slot's
    position is unique in its (n, c) map, so a plain indexed store does;
    dead slots all write into one spare element (no host sync)."""
    import torch
    import torch.nn.functional as F

    fmt, K = cp.fmt, cp.kernel
    N, C, K2, D = words.shape
    dev = words.device
    mask = (1 << fmt.bits_coord) - 1
    i_c = (words >> fmt.bits_coord) & mask
    live = (i_c < fmt.n_win) & (torch.arange(D, device=dev)
                                < counts[..., None])
    ph = torch.arange(K2, device=dev)[:, None]
    side = fmt.n_win * K
    y = i_c * K + ph // K
    x = (words & mask) * K + ph % K
    nc = torch.arange(N * C, device=dev).reshape(N, C, 1, 1)
    size = N * C * side * side
    m = torch.zeros(size + 1, device=dev)
    m[torch.where(live, (nc * side + y) * side + x, size).flatten()] = 1.0
    m = m[:size].reshape(N, C, side, side)[:, :, :cp.in_hw, :cp.in_hw]
    cur = F.conv2d(m, w.permute(3, 2, 0, 1), padding=K // 2)
    return vm + cur.permute(0, 2, 3, 1)


def b4_bf16(wt, ct, occ_t, cp, w, vm, kw4):
    """B4 in bf16 at one step. From the membrane and from a zero one it
    must equal the (c, phase)-ordered oracle in bf16 bit for bit (the same
    rounded adds in the same order). Against its plain version, which adds
    offset by
    offset, it is held to the worst case of two orders: a sum of m terms
    rounded in bf16 (u = 2^-8) lies within gamma_m * sum|x| of the exact
    one, gamma_m = m u / (1 - m u), so two orders differ by at most twice
    that. The stage must give every output fewer than 1/u adds."""
    import torch

    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import ref

    w16, vm16 = w.bfloat16().contiguous(), vm.bfloat16().contiguous()

    def kernel():
        return ea.event_accum_cuda(wt, ct, w16, vm16, **kw4)

    def plain():
        return ea.event_accum_plain(wt, ct, w16, vm16, **kw4)

    got, want = kernel(), plain()
    adds = ea.event_accum_plain(wt, ct, torch.ones_like(w),
                                torch.zeros_like(vm), **kw4)
    abs_sum = ea.event_accum_plain(wt, ct, w16.float().abs(),
                                   vm16.float().abs(), **kw4)
    u = 2.0 ** -8
    check(float(adds.max()) * u < 1, "B4 bf16: too many adds per output "
          "for the two-order bound")
    tol = 2 * adds * u / (1 - adds * u) * abs_sum
    err = (got.float() - want.float()).abs()
    check(bool((err <= tol).all()),
          f"B4 bf16: max |err| {float(err.max())} vs the plain version "
          "exceeds the two-order bound")
    okw = dict(K=cp.kernel, n_win=cp.fmt.n_win, depth=DEPTH, H=cp.in_hw,
               W=cp.in_hw)
    ordered = ref.fused_spike_accum_ordered_ref(occ_t, w16, init=vm16, **okw)
    check(torch.equal(got, ordered),
          "B4 bf16: differs from the ordered oracle from the membrane (max "
          f"|err| {float((got.float() - ordered.float()).abs().max())})")
    zero = ea.event_accum_cuda(wt, ct, w16, torch.zeros_like(vm16), **kw4)
    ordered = ref.fused_spike_accum_ordered_ref(occ_t, w16, **okw)
    check(torch.equal(zero, ordered),
          "B4 bf16: differs from the ordered oracle (max |err| "
          f"{float((zero.float() - ordered.float()).abs().max())})")
    return dict(bf16_ms=time_ms(kernel), bf16_plain_ms=time_ms(plain),
                bf16_max_abs_err=float(err.max()),
                bf16_tol_max=float(tol.max()))


def b4_repeats(wt, ct, cp, w, vm, w_dy, vm_dy, kw4):
    """B4 on a step's real queues with every live word written twice (the
    count doubled, capped at the depth): every cell repeats positions, so
    the decode flags them all and the gather adds each occurrence. Held:
    fp32 and bf16 equal the (c, phase)-ordered oracle on the decode's
    multiplicities bit for bit; against the plain version dyadic weights
    bit-exact, Gaussian ones within 1e-4 (other order of adds)."""
    import torch

    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import ref

    D = wt.shape[-1]
    wr = wt[..., torch.arange(D, device=wt.device) // 2].contiguous()
    cr = torch.clamp(ct * 2, max=D).contiguous()
    fmt = cp.fmt
    mult = ea.event_mult_plain(wr, cr, n_win=fmt.n_win, bits=fmt.bits_coord)
    check(int(ct.sum()) == 0 or int(mult.max()) >= 2,
          "B4 repeats: the doubled queues repeat no position")
    okw = dict(K=cp.kernel, n_win=fmt.n_win, depth=fmt.n_win ** 2,
               H=cp.in_hw, W=cp.in_hw, multiplicity=True)

    def kernel(w=w, vm=vm):
        return ea.event_accum_cuda(wr, cr, w, vm, **kw4)

    got = kernel()
    check(torch.equal(got, ref.fused_spike_accum_ordered_ref(
        mult, w, init=vm, **okw)),
        "B4 repeats: differs from the ordered oracle on the multiplicities")
    want = ea.event_accum_plain(wr, cr, w, vm, **kw4)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
          f"B4 repeats: Gaussian max |err| {err} vs the plain version")
    check(torch.equal(kernel(w_dy, vm_dy),
                      ea.event_accum_plain(wr, cr, w_dy, vm_dy, **kw4)),
          "B4 repeats: dyadic weights not bit-exact vs the plain version")
    w16, vm16 = w.bfloat16().contiguous(), vm.bfloat16().contiguous()
    check(torch.equal(kernel(w16, vm16), ref.fused_spike_accum_ordered_ref(
        mult, w16, init=vm16, **okw)),
        "B4 repeats: bf16 differs from the ordered oracle")
    return dict(rep_events=int(cr.sum()), rep_max_abs_err=err,
                rep_ms=time_ms(kernel),
                rep_device_ms=device_ms(kernel, KERNEL_NAMES["event_accum"]))


def phase_word_kernels(stages, device):
    """B5 and B4 on every event-driven stage's real activity at bucket 64
    (T=4, depth 64): B5 over the stage's B*T*C*K2 occupancy rows, B4 on the
    resulting queues at each of the T steps, both held against their plain
    versions, B4 also against the ordered oracle from the membrane, and
    timed."""
    import torch

    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_compact as sc

    gen = torch.Generator().manual_seed(SEED + 4)
    b5_rows, b4_rows, b4_err = [], [], 0.0
    for name, cp, occ, w_gauss in stages:
        fmt = cp.fmt
        N, C, K2, P = occ.shape
        rows = occ.reshape(-1, P)
        kw5 = dict(n_win=fmt.n_win, bits=fmt.bits_coord, depth=DEPTH,
                   invalid=fmt.invalid_word)

        def compact(rows=rows, kw5=kw5):
            return sc.spike_compact_cuda(rows, **kw5)

        def compact_plain(rows=rows, kw5=kw5):
            return sc.spike_compact_plain(rows, **kw5)

        (words, total), (w_p, t_p) = compact(), compact_plain()
        torch.cuda.synchronize()
        check(torch.equal(words, w_p) and torch.equal(total, t_p),
              f"B5 {name}: words or counts differ from the plain version")
        R = rows.shape[0]
        nbytes5 = 4 * (R * P + R * DEPTH + R)
        b_ms, b_by = bound(nbytes5, R * P, INT32_OP_PER_S)
        row5 = dict(stage=name, R=R, P=P, depth=DEPTH,
                    events=int(total.sum()),
                    overflow=int(torch.clamp(total - DEPTH, min=0).sum()),
                    bytes=nbytes5, ms=time_ms(compact),
                    device_ms=device_ms(compact, KERNEL_NAMES["spike_compact"]),
                    plain_ms=time_ms(compact_plain), library_ms=None,
                    bound_ms=b_ms, bound_by=b_by)
        b5_rows.append(row5)
        log(f"[word] B5 {name:21s} R={R} P={P} depth={DEPTH} events="
            f"{row5['events']} overflow={row5['overflow']} | ms "
            f"{row5['ms']:.4f} (device {row5['device_ms']:.4f}) plain "
            f"{row5['plain_ms']:.4f} library none "
            f"(no single PyTorch call compacts) bound {b_ms:.4f} ({b_by}) | "
            "bit-exact")

        # B4 on the stage's queues, one launch per step over the B rows
        B = N // T
        words = words.reshape(B, T, C, K2, DEPTH)
        counts = torch.clamp(total, max=DEPTH).reshape(B, T, C, K2)
        w_dy = (torch.randint(-96, 97, tuple(w_gauss.shape), generator=gen)
                / 256.0).to(device)
        vm_g = torch.randn((B, cp.in_hw, cp.in_hw, cp.out_c),
                           generator=gen).to(device)
        vm_dy = torch.round(vm_g * 16) / 16
        kw4 = dict(K=cp.kernel, n_win=fmt.n_win, bits=fmt.bits_coord)
        for t in range(T):
            wt, ct = words[:, t], counts[:, t]
            occ_t = occ.reshape(B, T, C, K2, P)[:, t]

            def accum(w=w_gauss, vm=vm_g, wt=wt, ct=ct, kw4=kw4):
                return ea.event_accum_cuda(wt, ct, w, vm, **kw4)

            def accum_plain(w=w_gauss, vm=vm_g, wt=wt, ct=ct, kw4=kw4):
                return ea.event_accum_plain(wt, ct, w, vm, **kw4)

            def library(wt=wt, ct=ct, cp=cp):
                return accum_library(wt, ct, w_gauss, vm_g, cp)

            got, want = accum(), accum_plain()
            ordered = ref.fused_spike_accum_ordered_ref(
                occ_t, w_gauss, K=cp.kernel, n_win=fmt.n_win, depth=DEPTH,
                H=cp.in_hw, W=cp.in_hw, init=vm_g)
            torch.cuda.synchronize()
            check(torch.equal(got, ordered),
                  f"B4 {name} t={t}: differs from the ordered oracle from the "
                  f"membrane (max |err| {float((got - ordered).abs().max())})")
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
                  f"B4 {name} t={t}: Gaussian max |err| {err}")
            lib_err = float((library() - want).abs().max())
            check(lib_err <= 1e-3, f"B4 {name} t={t}: the library yardstick "
                  f"computes another function (max |err| {lib_err})")
            got_dy = accum(w_dy, vm_dy)
            want_dy = accum_plain(w_dy, vm_dy)
            check(torch.equal(got_dy, want_dy),
                  f"B4 {name} t={t}: dyadic weights not bit-exact (max |err| "
                  f"{float((got_dy - want_dy).abs().max())})")
            b4_err = max(b4_err, err)
            live = int(ct.sum())
            adds = stage_work(occ_t, cp, DEPTH, w_gauss, device)[1]
            nbytes4 = (4 * live + ct.numel() * 4 + w_gauss.numel() * 4
                       + 2 * vm_g.numel() * 4)
            b_ms, b_by = bound(nbytes4, adds, FP32_FLOP_PER_S)
            row4 = dict(stage=name, t=t, N=B, C_in=C, hw=cp.in_hw,
                        C_out=cp.out_c, events=live, adds=adds,
                        bytes=nbytes4, max_abs_err=err, ms=time_ms(accum),
                        device_ms=device_ms(accum,
                                            KERNEL_NAMES["event_accum"]),
                        plain_ms=time_ms(accum_plain),
                        library_ms=time_ms(library), bound_ms=b_ms,
                        bound_by=b_by)
            if t == 0:
                row4.update(b4_repeats(wt, ct, cp, w_gauss, vm_g, w_dy,
                                       vm_dy, kw4))
                log(f"[word] B4 repeats {name} t=0, every live word twice "
                    f"({row4['rep_events']} live slots) | ms "
                    f"{row4['rep_ms']:.4f} (device "
                    f"{row4['rep_device_ms']:.4f}; without repeats "
                    f"{row4['device_ms']:.4f}) | == the ordered oracle on "
                    "the multiplicities, fp32 and bf16; max|err| vs plain "
                    f"{row4['rep_max_abs_err']:.3g}, dyadic bit-exact")
            if name.startswith("conv0") and t == 0:
                row4.update(b4_bf16(wt, ct, occ_t, cp, w_gauss, vm_g, kw4))
                log(f"[word] B4 bf16 {name} t=0 | ms {row4['bf16_ms']:.4f} "
                    f"(fp32 {row4['ms']:.4f}) plain "
                    f"{row4['bf16_plain_ms']:.4f} | max|err| vs plain "
                    f"{row4['bf16_max_abs_err']:.3g} within the two-order "
                    f"bound (max {row4['bf16_tol_max']:.3g}); == the ordered "
                    "oracle in bf16 from the membrane and from zero")
            b4_rows.append(row4)
        per = [r for r in b4_rows if r["stage"] == name]
        log(f"[word] B4 {name:21s} N={B} C_in={C} hw={cp.in_hw} C_out="
            f"{cp.out_c} events/step {[r['events'] for r in per]} | ms "
            f"{sum(r['ms'] for r in per):.4f} over {T} steps (device "
            f"{sum(r['device_ms'] for r in per):.4f}), plain "
            f"{sum(r['plain_ms'] for r in per):.4f}, library "
            f"{sum(r['library_ms'] for r in per):.4f}, bound "
            f"{sum(r['bound_ms'] for r in per):.4f} | == the ordered oracle "
            f"from the membrane, max|err| vs plain "
            f"{max(r['max_abs_err'] for r in per):.3g}, dyadic bit-exact")
    return b5_rows, b4_rows, b4_err


def phase_moe(device):
    """B6 at kernel_bench's shape and the test shapes, f32 and bf16, held
    bit-exactly against its plain version and the oracle; timed beside
    ``torch.index_select`` on x with one zero row appended. Its launches
    come from a window of its own: the one call kernel_bench makes."""
    import torch

    from repro_torch.kernels import moe_gather as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(SEED + 5)
    rows = []
    for (t, d, s, dtypes) in MOE_SHAPES:
        for dtype in (getattr(torch, n) for n in dtypes):
            x = torch.randn((t, d), generator=gen).to(dtype).to(device)
            idx = torch.randint(-1, t, (s,), generator=gen,
                                dtype=torch.int32).to(device)
            if (t, d, s) == MOE_SHAPES[0][:3] and dtype == torch.float32:
                ops.reset_launch_counts()          # kernel_bench's one call
                got = ops.moe_gather(x, idx)
                launches = ops.launch_counts["moe_gather"]
            else:
                got = mg.moe_gather_cuda(x, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, mg.moe_gather_plain(x, idx))
                  and torch.equal(got, ref.moe_gather_ref(x, idx)),
                  f"B6 ({t}, {d}, {s}) {dtype}: not bit-exact")
            x_pad = torch.cat([x, x.new_zeros((1, d))])
            idx_pad = torch.where(idx < 0, t, idx)

            def library(x_pad=x_pad, idx_pad=idx_pad):
                return torch.index_select(x_pad, 0, idx_pad)

            check(torch.equal(library(), got),
                  f"B6 ({t}, {d}, {s}): index_select differs")
            esize = x.element_size()
            used = int(torch.unique(idx[idx >= 0]).numel())
            nbytes = used * d * esize + s * d * esize + s * 4
            b_ms, b_by = bound(nbytes, 0, FP32_FLOP_PER_S)
            rows.append(dict(
                T=t, d=d, S=s, dtype=str(dtype).split(".")[-1],
                bytes=nbytes, max_abs_err=0.0,
                ms=time_ms(lambda: mg.moe_gather_cuda(x, idx)),
                device_ms=device_ms(lambda: mg.moe_gather_cuda(x, idx),
                                    KERNEL_NAMES["moe_gather"]),
                plain_ms=time_ms(lambda: mg.moe_gather_plain(x, idx)),
                library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by))
            r = rows[-1]
            log(f"[word] B6 T={t} d={d} S={s} {r['dtype']} | ms "
                f"{r['ms']:.4f} (device {r['device_ms']:.4f}) plain "
                f"{r['plain_ms']:.4f} library "
                f"{r['library_ms']:.4f} (index_select on x with a zero row "
                f"appended) bound {b_ms:.6f} ({b_by}) | bit-exact")
    log(f"[word] B6 launches in its window (kernel_bench's call): "
        f"{launches}")
    check(launches == 1, f"B6 launched {launches} times for one call")
    return rows, launches


def phase_word(params, ths, cfg, images, device, kind):
    """The word-level queue path and the dense backends at bucket 64:
    launches in the queue window, parity with queue_pallas, the mask
    contract, per-sample infer, dense against the CPU run, and profiled
    windows of queue and dense."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import ops

    dy = dyadic_params(params, device)
    imgs_dy = torch.round(images * 256) / 256
    cfg_w8 = cfg._replace(weight_bits=8)
    runs = {  # name -> (params, config, images)
        "gauss-fp32": (params, cfg, images),
        "gauss-w8": (params, cfg_w8, images),
        "dyadic-fp32": (dy, cfg, imgs_dy),
        "dyadic-w8": (dy, cfg_w8, imgs_dy),
        "dyadic-fp32-binary": (dy, cfg._replace(input_mode="binary"),
                               imgs_dy),
    }

    def infer(name, backend, imgs=None, **kw):
        p, c, im = runs[name]
        return engine.infer_batch(p, ths, c, im if imgs is None else imgs,
                                  backend=backend, device=device, **kw)

    ops.reset_launch_counts()                      # the main-path window
    out = {name: infer(name, "queue") for name in runs}
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)             # read right after
    log(f"[word] launches in the queue window ({len(runs)} calls): "
        f"{launches}")
    check(launches["spike_compact"] == 6 * 4 + 7,
          f"B5 launched {launches['spike_compact']} times (expected 6 per "
          "analog call, 7 per binary call: 31)")
    check(launches["event_accum"] == 24 * 4 + 28,
          f"B4 launched {launches['event_accum']} times (expected 24 per "
          "analog call, 28 per binary call: 124)")
    check(launches["fused_spike_accum"] == 0
          and launches["fused_spike_accum_sparse"] == 0,
          "B1 or B3 ran on the queue path")
    check(launches["quant_matmul"] == 2,
          f"B2 launched {launches['quant_matmul']} times (expected once per "
          "w8 call: 2)")

    parity = {}
    for name, (lg, st) in out.items():
        check(lg.shape == (images.shape[0], 10)
              and bool(torch.isfinite(lg).all()),
              f"{name}: logits not finite or of shape {tuple(lg.shape)}")
        la, sa = infer(name, "queue_pallas")
        same = torch.equal(lg, la) and _stats_equal(st, sa)
        parity[name] = dict(
            bit_exact=same, max_abs_logit_diff=float((lg - la).abs().max()),
            stats_differing=[f for f, x, y in zip(st._fields, st, sa)
                             if not torch.equal(x, y)])
        if name.startswith("dyadic"):
            check(same, f"queue {name} differs from queue_pallas: "
                  f"{parity[name]}")
    for k, v in parity.items():
        log(f"[word] queue vs queue_pallas {k}: " + (
            "bit-exact" if v["bit_exact"] else
            f"max |logit diff| {v['max_abs_logit_diff']:.3g}, stats that "
            f"differ {v['stats_differing']} (reported, not held: queue adds "
            "the events into the membrane and then the bias, queue_pallas "
            "adds one current)"))

    n = images.shape[0] // 2 + 1                   # 33 of 64
    mask, rows_ok, cpu_ok = {}, {}, {}
    for be in ("queue", "dense", "dense_unrolled"):
        for name in ("gauss-fp32", "gauss-w8", "dyadic-fp32"):
            p, c, im = runs[name]
            lp, sp_ = engine.infer_batch_masked(p, ths, c, im, n, backend=be,
                                                device=device)
            lu, su = infer(name, be, im[:n])
            same = torch.equal(lp, lu) and _stats_equal(sp_, su)
            mask[f"{be} {name}"] = same
            check(same, f"{be} mask contract broken on {name}: max |logit "
                  f"diff| {float((lp - lu).abs().max())}")
            for i in range(3):                     # per-sample infer
                l1, s1 = engine.infer(p, ths, c, im[i], backend=be,
                                      device=device)
                check(torch.equal(l1, lu[i])
                      and all(torch.equal(a, b[i]) for a, b in zip(s1, su)),
                      f"{be} {name}: infer on image {i} differs from its "
                      "row of infer_batch")
            rows_ok[f"{be} {name}"] = True
        # card == CPU: Gaussian nets only where the card adds in the CPU's
        # order (the cuDNN conv); B4 adds in (c, phase) order, the plain
        # version offset by offset, so a spike at the threshold could flip
        held = ("dyadic-fp32", "dyadic-fp32-binary") + (
            ("gauss-fp32",) if be != "queue" else ())
        for name in held:
            p, c, im = runs[name]
            small = im[:3]
            lg, sg = infer(name, be, small)
            lc, sc = engine.infer_batch(
                [{k: v.cpu() for k, v in layer.items()} for layer in p],
                [t.cpu() for t in ths], c, small.cpu(), backend=be,
                device="cpu")
            stats_same = _stats_equal([a.cpu() for a in sg], sc)
            diff = float((lg.cpu() - lc).abs().max())
            cpu_ok[f"{be} {name}"] = dict(stats_equal=stats_same,
                                          max_abs_logit_diff=diff)
            check(stats_same, f"{be} {name}: card stats differ from the CPU "
                  "run")
            if name.startswith("dyadic"):
                check(diff == 0.0, f"{be} {name}: card logits differ from the "
                      f"CPU run by {diff}")
    log(f"[word] padded (n={n} of {images.shape[0]}) == unpadded: {mask}")
    log(f"[word] infer on 3 images == the batch rows: {rows_ok}")
    log(f"[word] card == CPU run on 3 images (stats held; logits held on "
        f"the dyadic nets): {cpu_ok}")

    def call(name, backend):
        def run():
            infer(name, backend)
            torch.cuda.synchronize()
        return run

    windows = {}
    calls = {be: call("gauss-fp32", be) for be in ("queue", "dense")}
    for be in calls:
        calls[be]()                                # warm
    for i in range(PROFILE_WINDOWS):               # in turns
        order = list(calls) if i % 2 == 0 else list(calls)[::-1]
        for be in order:
            windows.setdefault(f"gauss-fp32 {be}", []).append(
                profile_window(calls[be]))
    summary = {k: dict(windows=w, **log_windows("word", k, w, kind))
               for k, w in windows.items()}
    return dict(launches=launches, parity=parity, mask_contract=mask,
                infer_rows=rows_ok, card_vs_cpu=cpu_ok, profile=summary)


def phase_profile(params, ths, cfg, images, kind):
    """Where a bucket-64 execution's time goes, for an fp32 and a
    ``weight_bits=8`` serving handle: ``PROFILE_WINDOWS`` windows of 5
    synchronized graph replays (``run_bucket``) and, in turns, of 5 eager
    ``engine.infer_batch`` calls of the same bucket (:func:`profile_window`).
    The replay windows also count the port's kernels by name, where the
    profiler reports the kernels a graph runs: B1's gather 6 times and
    B2's once (w8) per replay."""
    import torch

    from repro_torch.core import engine
    from repro_torch.serve import ModelRegistry

    registry = ModelRegistry(device=images.device)
    handles = {n: registry.register(n, params, ths, c) for n, c in (
        ("cifar10-fp32", cfg), ("cifar10-w8", cfg._replace(weight_bits=8)))}
    host = images.cpu().numpy()
    B, out = images.shape[0], {}
    for name, h in handles.items():
        def replay(h=h):
            h.run_bucket(host, B)

        def eager(h=h):
            engine.infer_batch(h.params, h.thresholds, h.cfg, host,
                               backend=h.backend, device=images.device)
            torch.cuda.synchronize()

        replay()                                   # capture
        eager()                                    # warm
        windows = {"replay": [], "eager": []}
        for i in range(PROFILE_WINDOWS):           # in turns
            order = ("replay", "eager") if i % 2 == 0 else ("eager", "replay")
            for k in order:
                windows[k].append(profile_window(replay if k == "replay"
                                                 else eager))
        calls = windows["replay"][-1]["port_kernel_calls"]
        want = {"fused_spike_accum_gather": 6,
                "quant_matmul": int(name.endswith("w8"))}
        seen = all(calls.get(k, 0) == v for k, v in want.items())
        log(f"[profile] {name}: kernels per replay by name in the profiled "
            f"window: {calls} ("
            + ("== B1's 6 gathers and B2's launches per bucket" if seen else
               "the profiler did not report each graph kernel as expected")
            + ")")
        out[name] = dict(bucket=B, kernels_per_replay=calls,
                         graph_kernels_reported=seen)
        for k, w in windows.items():
            out[name][k] = dict(windows=w, **log_windows(
                "profile", f"{name} {k}", w, kind))
    return out


# ---------------------------------------------------------------------------
# The study pipeline: train -> convert -> collect -> price -> serve
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_calls(targets, seconds, outputs):
    """For the block, wrap ``module.name`` for each ``(module, name)`` of
    ``targets``: each call's seconds (host clock, the card synchronized
    first and last) add up in ``seconds[name]`` and its result is appended
    to ``outputs[name]``. The originals come back after the block."""
    import torch

    originals = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            outputs.setdefault(name, []).append(out)
            return out
        return wrapper

    for m, n, fn in originals:
        setattr(m, n, wrap(n, fn))
    try:
        yield
    finally:
        for m, n, fn in originals:
            setattr(m, n, fn)


STUDY_VARIANTS = [dict(compressed=c, vmem_resident=v)
                  for c in (True, False) for v in (True, False)]
STUDY_REQUESTS = 64


def phase_study(kind, cache):
    """The paper's experiment on the card through the port's study API:
    ``study.run(StudySpec("cifar10", backend="queue_pallas"))`` with a
    fresh in-memory cache at the full-width CIFAR-10 net and StudySpec's
    own recipe, then the pricing sweep, the same converted net collected on
    ``queue_sparse`` at ``weight_bits=8``, and that net served through
    ``register_study``. Stage seconds come from timers wrapped around the
    stage functions ``run`` calls (each synchronizes the card first and
    last); the launch counters are zeroed before each window and read
    after it."""
    import numpy as np
    import torch

    from repro_torch import study
    from repro_torch.kernels import ops
    from repro_torch.serve import bench
    from repro_torch.study import stages

    spec = study.StudySpec(dataset="cifar10", backend="queue_pallas")
    seconds, outputs = {}, {}
    with timed_calls([(stages, n) for n in ("train", "convert", "collect",
                                            "price", "fit_cnn")],
                     seconds, outputs):
        study.reset_stage_counts()
        ops.reset_launch_counts()                  # the study window
        t0 = time.perf_counter()
        report = study.run(spec, cache=cache)
        run_s = time.perf_counter() - t0
        run_stages = dict(seconds)
        seconds.clear()
        t0 = time.perf_counter()
        reports = study.sweep(spec, STUDY_VARIANTS, cache=cache)
        sweep_s = time.perf_counter() - t0
        sweep_stages = dict(seconds)
        counted = dict(ops.launch_counts)           # read right after
        counts = dict(study.stage_counts)
    losses = [float(out[1]) for out in outputs["fit_cnn"]]

    batches = -(-spec.n_eval // spec.batch)
    log(f"[study] run(StudySpec('cifar10', backend='queue_pallas')) on "
        f"{kind}: {spec.net}, n_train {spec.n_train} x {spec.epochs} epochs "
        f"(batch {spec.train_batch}), n_eval {spec.n_eval} (batch "
        f"{spec.batch}), T={spec.T}, depth {spec.depth}: {run_s:.2f} s; "
        "stages " + ", ".join(f"{n} {v:.2f} s" for n, v in run_stages.items())
        + f" (fit_cnn inside train); final training loss (last step) "
        f"{losses[-1]:.4f}")
    for name, value in report.summary_rows():
        log(f"[study]   {name:>18s} {value}")
    log(f"[study] sweep over compressed x vmem_resident ({len(reports)} "
        f"variants, same cache) {sweep_s:.2f} s (stage calls, cache hits "
        "included: " + ", ".join(f"{n} {v:.2f} s" for n, v in
                                 sweep_stages.items())
        + f"); stage executions in run + sweep {counts}; launches "
        f"{_nonzero(counted)}")
    check(counts == {"train": 1, "convert": 1, "collect": 1},
          f"run + a 4-variant pricing sweep executed stages {counts}, "
          "expected one train, one convert, one collect")
    check(counted["fused_spike_accum"] == 6 * batches,
          f"B1 launched {counted['fused_spike_accum']} times in the study's "
          f"collect, expected 6 x {batches}")
    check(sum(counted.values()) == counted["fused_spike_accum"],
          f"the study window launched another kernel: {counted}")
    check(report.snn_energy_j.shape == (spec.n_eval,)
          and np.isfinite(report.snn_energy_j).all()
          and np.isfinite(report.snn_latency_s).all()
          and np.isfinite(report.cnn_energy_j) and 0 <= report.snn_acc <= 1,
          "the study report is not finite or of the eval set's shape")
    same = reports[0]
    check(same.spec == spec and same.snn_energy_j.tobytes()
          == report.snn_energy_j.tobytes() and same.snn_acc == report.snn_acc,
          "the sweep's (compressed, VMEM) variant differs from run's report")
    check(all(np.array_equal(r.spikes_per_sample, report.spikes_per_sample)
              for r in reports),
          "pricing variants disagree on the recorded spikes")

    # the same converted net on queue_sparse at weight_bits=8 (B3 + B2)
    trained = study.train(spec, cache=cache)
    converted = study.convert(spec, trained, cache=cache)
    eval_images, eval_labels = spec.load_eval()
    sparse_spec = spec.replace(backend="queue_sparse", weight_bits=8)
    ops.reset_launch_counts()                      # the queue_sparse window
    t0 = time.perf_counter()
    sparse_col = study.collect(sparse_spec, converted, images=eval_images,
                               cache=cache)
    sparse_s = time.perf_counter() - t0
    sparse_counted = dict(ops.launch_counts)
    sparse_report = study.price(sparse_spec, sparse_col, trained,
                                eval_labels)
    log(f"[study] queue_sparse w8 collect of the same converted net: "
        f"{sparse_s:.2f} s; launches {_nonzero(sparse_counted)}; snn_acc "
        f"{sparse_report.snn_acc:.4f} (queue_pallas fp32 "
        f"{report.snn_acc:.4f}), overflow {sparse_report.overflow} "
        f"(queue_pallas {report.overflow})")
    check(sparse_counted["fused_spike_accum_sparse"] == 6 * batches
          and sparse_counted["quant_matmul"] == batches
          and sparse_counted["fused_spike_accum"] == 0,
          f"queue_sparse w8 collect launched {sparse_counted}, expected B3 "
          f"6 x {batches} and B2 {batches}")
    check(np.isfinite(sparse_col.snn_logits).all(),
          "queue_sparse w8 logits are not finite")

    # serve the study's net: register_study on the same spec and cache
    images = bench.request_images("cifar10", STUDY_REQUESTS)
    study.reset_stage_counts()
    ops.reset_launch_counts()                      # the serving window
    t0 = time.perf_counter()
    runtime, name = bench.build_runtime(spec, BUCKETS, trained=True,
                                        cache=cache)
    warm_s = time.perf_counter() - t0
    handle = runtime.registry.get(name)
    replays0 = dict(handle.replay_count)
    res = bench.closed_loop(runtime, name, images)
    serve_counted = dict(ops.launch_counts)
    check(dict(study.stage_counts) == {},
          f"register_study re-ran study stages: {dict(study.stage_counts)}")
    check(handle.source_key == converted.key,
          "the served handle is not the study's converted net")
    replayed = _graph_launches({name: handle}, {name: replays0})
    parity = bench.verify_energy_parity(runtime, name, images,
                                        res.responses)
    one_col = study.collect(spec, converted, images=images,
                            cache=study.StudyCache())
    one_shot = study.price_record(one_col.stats, input_hw=spec.input_hw)
    served = bench.energy_array(res.responses)
    check(parity["elementwise_bitexact"] and parity["sum_bitexact"]
          and served.tobytes() == one_shot.total_j.numpy().tobytes(),
          f"served energies differ from one-shot collect + price: {parity}")
    check(res.n_requests == STUDY_REQUESTS, f"{res.n_requests} responses")
    log(f"[study] register_study + build_runtime(spec, trained=True): "
        f"warmup {warm_s:.2f} s (no stage re-ran), {res.n_requests} requests "
        f"at {res.throughput_rps:.1f} req/s, buckets {res.bucket_histogram}; "
        f"captures {_nonzero(serve_counted)}, replayed launches "
        f"{_nonzero(replayed)}; served energies == one-shot collect + "
        f"price_record and infer_batch + price_record, bit for bit "
        f"(sum {float(served.sum()):.6g} J, pricing model)")
    return dict(
        spec={f: getattr(spec, f) for f in (
            "dataset", "net", "n_train", "epochs", "train_batch", "lr",
            "train_weight_bits", "percentile", "n_balance", "T", "depth",
            "mode", "input_mode", "n_eval", "batch", "backend")},
        run_s=run_s, stage_s=run_stages, final_loss=losses[-1],
        snn_acc=report.snn_acc,
        summary_rows=report.summary_rows(), report=report.to_json(),
        thresholds=[float(t) for t in converted.thresholds],
        sweep_s=sweep_s, sweep_stage_s=sweep_stages,
        sweep_rows=study.sweep_rows(reports), stage_counts=counts,
        launches=_nonzero(counted), batches=batches,
        sparse=dict(seconds=sparse_s, launches=_nonzero(sparse_counted),
                    report=sparse_report.to_json()),
        serve=dict(warmup_s=warm_s, requests=res.n_requests,
                   requests_per_s=res.throughput_rps,
                   bucket_histogram=res.bucket_histogram,
                   captures=_nonzero(serve_counted),
                   replayed=_nonzero(replayed), energy_parity=parity))


# ---------------------------------------------------------------------------
# Direct surrogate-gradient training: train_snn -> collect -> price
# ---------------------------------------------------------------------------

RESUME_IMAGES = 256   # the resume check's training images (2 batches)
STEP_WINDOWS = 3      # profiled windows of 5 training steps
GRAD_BATCH = 8        # the card-against-CPU gradient check's batch
GRAD_TOL = 1e-5       # of each gradient's norm, card against CPU


def _params_bytes(params):
    return [{k: v.detach().cpu().numpy().tobytes() for k, v in p.items()}
            for p in params]


def _loss_and_grads(loss_fn, params, images, labels):
    """The loss and every parameter's gradient (autograd) on the params'
    device."""
    import torch

    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in params]
    with torch.enable_grad():
        loss = loss_fn(leaves, images, labels)
        flat = [v for p in leaves for v in p.values()]
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), [g.detach() for g in grads]


def phase_direct(kind, cache, convert_acc):
    """Direct training of the full-width CIFAR-10 net on the card through
    the port's study API: ``study.run(StudySpec("cifar10",
    training="direct", backend="queue_pallas"))`` on the study phase's own
    cache (the CNN ``train`` a hit), StudySpec's recipe uncut; then a second
    training of the same spec on a fresh cache (bit-equal params), a
    checkpoint resume (bit-equal to the uninterrupted run), profiled
    windows of training steps, the card's gradient against the port's CPU
    run on dyadic inputs, an export/load round trip whose collect equals
    the original's bit for bit, and the rate encoder with a CUDA
    generator."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import study
    from repro_torch.core import engine, snn_model
    from repro_torch.core.encoding import encode_rate
    from repro_torch.kernels import ops
    from repro_torch.study import stages
    from repro_torch.training import surrogate
    from repro_torch.training.optimizer import adamw_init

    spec = study.StudySpec(dataset="cifar10", training="direct",
                           backend="queue_pallas")
    seconds, outputs = {}, {}
    with timed_calls([(stages, n) for n in ("train", "train_snn", "collect",
                                            "price")]
                     + [(surrogate, "fit_snn")], seconds, outputs):
        study.reset_stage_counts()
        surrogate.reset_step_counts()
        ops.reset_launch_counts()                  # the direct study window
        t0 = time.perf_counter()
        report = study.run(spec, cache=cache)
        run_s = time.perf_counter() - t0
        counted = dict(ops.launch_counts)          # read right after
        counts = dict(study.stage_counts)
        steps = surrogate.step_counts["steps"]
    losses = [float(out[2]) for out in outputs["fit_snn"]]

    batches = -(-spec.n_eval // spec.batch)
    plan = engine.compile_plan(spec.net, spec.input_hw, spec.input_c)
    event_stages = len(plan.convs) - (spec.input_mode == "analog")
    want_steps = spec.snn_epochs * -(-spec.n_train // spec.snn_batch)
    ms_per_step = seconds["fit_snn"] / steps * 1e3
    log(f"[direct] run(StudySpec('cifar10', training='direct', "
        f"backend='queue_pallas')) on {kind}: {spec.net}, n_train "
        f"{spec.n_train} x {spec.snn_epochs} epochs (batch {spec.snn_batch}, "
        f"lr {spec.snn_lr}, {spec.surrogate} beta {spec.sg_beta}, target "
        f"{spec.loss_target}), T={spec.T}, {spec.mode}, {spec.input_mode}: "
        f"{run_s:.2f} s; stages " + ", ".join(
            f"{n} {v:.3f} s" for n, v in seconds.items())
        + f" (fit_snn inside train_snn); {steps} steps, {ms_per_step:.2f} ms "
        f"a step; final loss (last step) {losses[-1]:.4f}")
    for name, value in report.summary_rows():
        log(f"[direct]   {name:>18s} {value}")
    log(f"[direct] SNN accuracy: direct {report.snn_acc:.4f}, converted "
        f"(study phase) {convert_acc:.4f}; CNN {report.cnn_acc:.4f}; "
        f"overflow {report.overflow}; stage executions {counts}; launches "
        f"{_nonzero(counted)}")
    check(counts == {"train_snn": 1, "collect": 1},
          f"the direct run executed stages {counts}, expected train_snn 1 "
          "and collect 1 (the CNN train a cache hit)")
    check(steps == want_steps, f"{steps} optimizer steps, expected "
          f"{want_steps}")
    check(counted["fused_spike_accum"] == event_stages * batches
          and sum(counted.values()) == counted["fused_spike_accum"],
          f"the direct window launched {counted}, expected B1 "
          f"{event_stages} x {batches} and nothing else")
    check(report.overflow == 0, f"overflow {report.overflow}")
    check(report.snn_energy_j.shape == (spec.n_eval,)
          and np.isfinite(report.snn_energy_j).all()
          and np.isfinite(losses[-1]) and 0 <= report.snn_acc <= 1,
          "the direct report is not finite or of the eval set's shape")

    # one recipe trains one net
    art = study.train_snn(spec, cache=cache)
    t0 = time.perf_counter()
    again = study.train_snn(spec, cache=study.StudyCache())
    again_s = time.perf_counter() - t0
    check(_params_bytes(again.snn_params) == _params_bytes(art.snn_params),
          "two trainings of one spec on the card gave different params")
    log(f"[direct] a second train_snn of the spec on a fresh cache "
        f"({again_s:.2f} s): params bit-equal")

    # a checkpoint resume is bit-exact: 2 epochs, then on to 3
    images, labels = spec.load_train()
    images, labels = images[:RESUME_IMAGES], labels[:RESUME_IMAGES]
    recipe = dict(T=spec.T, mode=spec.mode, input_mode=spec.input_mode,
                  input_theta=spec.input_theta, v_init_frac=spec.v_init_frac,
                  batch=spec.snn_batch, lr=spec.snn_lr,
                  target=spec.loss_target, rate_reg=spec.rate_reg,
                  surrogate=spec.surrogate, beta=spec.sg_beta,
                  init_seed=spec.snn_init_seed)
    full, _, _ = surrogate.fit_snn(spec.net, images, labels, epochs=3,
                                   **recipe)
    with tempfile.TemporaryDirectory() as ckpt:
        surrogate.fit_snn(spec.net, images, labels, epochs=2, ckpt_dir=ckpt,
                          **recipe)
        surrogate.reset_step_counts()
        resumed, _, _ = surrogate.fit_snn(spec.net, images, labels, epochs=3,
                                          ckpt_dir=ckpt, **recipe)
        resume_steps = surrogate.step_counts["steps"]
    check(resume_steps == -(-RESUME_IMAGES // spec.snn_batch),
          f"the resume ran {resume_steps} steps, expected one epoch")
    check(_params_bytes(resumed) == _params_bytes(full),
          "resuming from the epoch-2 checkpoint differs from 3 epochs")
    log(f"[direct] resume on {RESUME_IMAGES} images: 2 epochs with "
        f"checkpoints, then to 3 ({resume_steps} steps) == 3 uninterrupted "
        "epochs, bit for bit")

    # profiled training steps of the trained net at the recipe's batch:
    # wall, device busy and idle share from the same steps
    device = torch.device("cuda")
    cfg = spec.snn_config()
    step, loss_fn = surrogate.make_snn_train_step(
        cfg, art.thresholds, target=spec.loss_target, rate_reg=spec.rate_reg,
        surrogate=spec.surrogate, beta=spec.sg_beta, lr=spec.snn_lr)
    xb = torch.as_tensor(images[:spec.snn_batch], device=device)
    yb = torch.as_tensor(labels[:spec.snn_batch], device=device)
    state = [art.snn_params, adamw_init(art.snn_params)]

    def train_step():
        state[0], state[1], _ = step(state[0], state[1], xb, yb)
        torch.cuda.synchronize()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True      # as fit_snn runs
    try:
        step_windows = [profile_window(train_step)
                        for _ in range(STEP_WINDOWS)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    steps_o = {k: spread([w[k] for w in step_windows]) for k in WINDOW_KEYS}
    log(f"[direct] training steps (batch {spec.snn_batch}), "
        f"{STEP_WINDOWS} windows x 5 steps, median (min, max): wall "
        f"{fmt_spread(steps_o['wall_ms'])} ms, device busy "
        f"{fmt_spread(steps_o['device_busy_ms'])} ms in "
        f"{step_windows[-1]['device_ops']} device ops, idle share "
        f"{fmt_spread(steps_o['idle_share'])} | unprofiled wall "
        f"{fmt_spread(steps_o['unprofiled_wall_ms'])} ms")
    for r in step_windows[-1]["top"][:6]:
        log(f"[direct]   {r['ms']:9.4f} ms  x{r['calls']:<4d} {r['name']}")

    # the card's forward and gradient against the port's CPU run, on
    # dyadic params and images (exact forward sums), TF32 off
    gen = torch.Generator().manual_seed(SEED + 7)
    params = dyadic_params(snn_model.init_params(
        gen, spec.net, spec.input_hw, spec.input_c, device=device), device)
    ths = surrogate.unit_thresholds(spec.net, spec.input_hw, spec.input_c,
                                    device=device)
    x = torch.round(torch.as_tensor(images[:GRAD_BATCH], device=device)
                    * 256) / 256
    y = torch.as_tensor(labels[:GRAD_BATCH], device=device)
    _, loss_fn = surrogate.make_snn_train_step(
        cfg, ths, target=spec.loss_target, rate_reg=spec.rate_reg,
        surrogate=spec.surrogate, beta=spec.sg_beta)
    step_logits, rates = engine.train_forward(params, ths, cfg, x)
    logits, stats = engine.infer_batch(params, ths, cfg, x, backend="dense")
    sizes = torch.tensor([spec.T * cp.out_hw * cp.out_hw * cp.out_c
                          for cp in plan.convs], device=device)
    spikes = torch.round(rates.detach() * sizes).to(torch.int32)
    check(torch.equal(spikes, stats.spikes_out[:, :len(plan.convs)]),
          "train_forward's spikes differ from infer_batch(dense)'s on the "
          "card")
    fwd_err = float((step_logits.detach().sum(1) - logits).abs().max())
    check(fwd_err <= 1e-4, f"summed step_logits differ from the dense "
          f"logits by {fwd_err}")
    loss_gpu, grads_gpu = _loss_and_grads(loss_fn, params, x, y)
    cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
    ths_cpu = [t.cpu() for t in ths]
    _, loss_fn_cpu = surrogate.make_snn_train_step(
        cfg, ths_cpu, target=spec.loss_target, rate_reg=spec.rate_reg,
        surrogate=spec.surrogate, beta=spec.sg_beta)
    _, rates_cpu = engine.train_forward(cpu, ths_cpu, cfg, x.cpu())
    loss_cpu, grads_cpu = _loss_and_grads(loss_fn_cpu, cpu, x.cpu(), y.cpu())
    check(torch.equal(rates.detach().cpu(), rates_cpu),
          "the card's spike rates differ from the CPU's on dyadic inputs")
    grad_err = max(float((g.cpu() - c).abs().max() / c.norm().clamp_min(1e-30))
                   for g, c in zip(grads_gpu, grads_cpu))
    loss_err = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    check(grad_err <= GRAD_TOL and loss_err <= 1e-6,
          f"the card's gradients differ from the CPU's by {grad_err} of "
          f"their norm (loss {loss_err} relative)")
    log(f"[direct] dyadic batch {GRAD_BATCH} on the card: train_forward's "
        "spikes == infer_batch(dense)'s, summed step_logits within "
        f"{fwd_err:.2e} of its logits; rates == the CPU's; loss "
        f"{float(loss_gpu):.6f} (CPU {float(loss_cpu):.6f}, {loss_err:.2e} "
        f"relative), worst gradient {grad_err:.2e} of its norm (bound "
        f"{GRAD_TOL})")

    # export, load, collect again: the same stats, bit for bit
    eval_images, _ = spec.load_eval()
    col = study.collect(spec, art, images=eval_images, cache=cache)
    with tempfile.TemporaryDirectory() as root:
        study.export_artifact(art, root)
        loaded = study.load_artifact(root)
    check(type(loaded) is study.DirectTrainArtifact and loaded.key == art.key
          and _params_bytes(loaded.snn_params) == _params_bytes(
              art.snn_params), "the loaded export differs from the artifact")
    col2 = study.collect(spec, loaded, images=eval_images,
                         cache=study.StudyCache())
    check(all(np.array_equal(getattr(col.stats, f), getattr(col2.stats, f))
              for f in study.StatsRecord._fields)
          and col.snn_logits.tobytes() == col2.snn_logits.tobytes(),
          "the exported net's collect differs from the original's")
    log("[direct] export_artifact -> load_artifact on the card: params "
        "bit-equal, collect stats and logits bit-equal")

    # the rate encoder with a CUDA generator
    half = torch.full((64, spec.input_hw, spec.input_hw, spec.input_c), 0.5,
                      device=device)
    r1 = encode_rate(half, 64, torch.Generator(device=device).manual_seed(0))
    r2 = encode_rate(half, 64, torch.Generator(device=device).manual_seed(0))
    rate = float(r1.mean())
    check(torch.equal(r1, r2) and abs(rate - 0.5) < 0.05,
          f"encode_rate on the card: same seed equal {torch.equal(r1, r2)}, "
          f"mean rate {rate}")
    log(f"[direct] encode_rate with a CUDA generator: one seed one raster, "
        f"mean rate {rate:.4f} at x = 0.5, T = 64")
    return dict(
        spec={f: getattr(spec, f) for f in (
            "dataset", "net", "n_train", "snn_epochs", "snn_batch", "snn_lr",
            "surrogate", "sg_beta", "loss_target", "rate_reg", "T", "depth",
            "mode", "input_mode", "n_eval", "batch", "backend")},
        run_s=run_s, stage_s=seconds, steps=steps, ms_per_step=ms_per_step,
        final_loss=losses[-1], summary_rows=report.summary_rows(),
        report=report.to_json(), convert_snn_acc=convert_acc,
        stage_counts=counts, launches=_nonzero(counted),
        second_train_s=again_s, resume_steps=resume_steps,
        step_windows=step_windows, step_spread=steps_o,
        forward_err=fwd_err, grad_err=grad_err, loss_err=loss_err,
        encode_rate_mean=rate)


# ---------------------------------------------------------------------------
# Observability and the replica fleet
# ---------------------------------------------------------------------------

def _responses_equal(a, b):
    """Two closed-loop results (rid order) answer alike: logits, the five
    stats rows and float32 energies, request by request."""
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x.logits, y.logits)
               and np.float32(x.energy_j) == np.float32(y.energy_j)
               and all(np.array_equal(p, q) for p, q in zip(x.stats, y.stats))
               for x, y in zip(a, b))


def phase_obs(params, device, kind):
    """The closed loop with tracing off and on, in turns: responses
    bit-identical, the trace complete, the summarizer renders it."""
    from repro_torch import obs
    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.obs.summarize import summarize
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime
    from repro_torch.serve import bench

    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    images, _ = make_cifar_like(N_REQUESTS, seed=SEED + 7)
    registry = ModelRegistry(device=device)
    registry.register("cifar10-fp32", params, th, cfg).warmup(BUCKETS)
    runtime = ServeRuntime(registry, BucketPolicy(BUCKETS))
    trace_path = ROOT / "chiprun_out" / "obs_trace.jsonl"
    rates = {False: [], True: []}
    first = None
    for i in range(OBS_RUNS):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            obs.reset()
            if traced:
                obs.enable()
            batches0 = runtime.n_batches
            res = bench.closed_loop(runtime, "cifar10-fp32", images)
            obs.disable()
            rates[traced].append(res.throughput_rps)
            first = first or res.responses
            check(res.n_requests == N_REQUESTS
                  and _responses_equal(first, res.responses),
                  f"[obs] a {'traced' if traced else 'untraced'} run "
                  "answered differently from the first run")
            if not traced:
                continue
            spans = obs.spans()
            executes = [x for x in spans if x.name == "serve.execute"]
            requests = [e for e in obs.events() if e.name == "serve.request"]
            counters = obs.metrics_snapshot()["counters"]
            batches = runtime.n_batches - batches0
            check(len(executes) == batches == counters.get("serve.batches")
                  and any(x.name == "serve.price" for x in spans)
                  and len(requests) == N_REQUESTS
                  and counters.get("serve.requests") == N_REQUESTS,
                  f"[obs] the trace is incomplete: {len(executes)} "
                  f"serve.execute spans for {batches} batches, "
                  f"{len(requests)} serve.request events, counters "
                  f"{counters}")
            obs.save_jsonl(str(trace_path))
            n_spans, n_events = len(spans), len(obs.events())
    report = summarize(str(trace_path), limit=4)
    check("serve.execute" in report and "batch-form" in report,
          "[obs] the summarizer did not render the trace")
    out = dict(traced_rps=spread(rates[True]),
               untraced_rps=spread(rates[False]),
               runs=OBS_RUNS, trace=str(trace_path.relative_to(ROOT)),
               spans=n_spans, events=n_events)
    log(f"[obs] {kind}: closed loop, {N_REQUESTS} requests, {OBS_RUNS} runs "
        "each in turns: untraced req/s "
        f"{fmt_spread(out['untraced_rps'], '{:.1f}')}, traced req/s "
        f"{fmt_spread(out['traced_rps'], '{:.1f}')}; responses bit-identical "
        f"in all {2 * OBS_RUNS} runs; last trace {out['spans']} spans, "
        f"{out['events']} events (serve.request 1 a request), summarized")
    for line in report.splitlines():
        if line.startswith("| serve."):
            log(f"[obs]   {line}")
    obs.reset()
    return out


def phase_fleet(params, device, kind):
    """Save a two-handle registry, restore it in-process (replays equal
    the builder's), then serve it from two replica processes that share
    the build phase's kernel libraries."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.kernels import _cuda, ops
    from repro_torch.serve import (ModelRegistry, fleet, load_registry,
                                   save_registry)
    from repro_torch.serve.bench import request_images

    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    ck_dir = FLEET_DIR / "registry"
    shutil.rmtree(ck_dir, ignore_errors=True)

    ops.reset_launch_counts()                      # the phase's window
    builder = ModelRegistry(device=device)
    for name, bits in (("cifar10-fp32", None), ("cifar10-w8", 8)):
        builder.register(name, params, th, cfg._replace(weight_bits=bits))
        builder.get(name).warmup(BUCKETS)
    t0 = time.perf_counter()
    save_registry(builder, str(ck_dir))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = load_registry(str(ck_dir), device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imgs, _ = make_cifar_like(max(BUCKETS), seed=SEED + 13)
    cases = 0
    for name in builder.names():
        h, b_h = restored.get(name), builder.get(name)
        check(h.cached_buckets() == BUCKETS and h.compile_count == 0,
              f"[fleet] {name}: restored buckets {h.cached_buckets()}, "
              f"compile_count {h.compile_count}")
        for b in BUCKETS:
            for n in sorted({b, b // 2 + 1}):
                lr, sr = h.run_bucket(imgs[:b], n)
                lb, sb = b_h.run_bucket(imgs[:b], n)
                check(torch.equal(lr, lb) and _stats_equal(sr, sb),
                      f"[fleet] {name} bucket {b}, {n} valid: the restored "
                      "replay differs from the builder's")
                cases += 1
        h.warmup(BUCKETS)
        check(h.compile_count == 0, f"[fleet] {name}: warmup recaptured")
    requests = request_images("cifar10", 16, seed=2026)   # the fleet's own
    inproc, _ = fleet.serve_requests(restored, requests, BUCKETS)
    counted = dict(ops.launch_counts)
    replayed = fleet.replayed_launches(builder)
    for k, v in fleet.replayed_launches(restored).items():
        replayed[k] = replayed.get(k, 0) + v
    log(f"[fleet] saved {len(builder)} handles x buckets {BUCKETS} in "
        f"{save_s:.3f} s; load_registry (params + {len(BUCKETS)} captures "
        f"a handle) {load_s:.3f} s; restored replay == builder's replay in "
        f"{cases} (handle, bucket, valid rows) cases, compile_count 0")

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.serve.fleet", "--replicas",
           "2", "--dataset", "cifar10", "--buckets",
           ",".join(map(str, BUCKETS)), "--cache-dir", str(FLEET_DIR),
           "--timeout", "600"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=700)
    fleet_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[fleet] the fleet exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    replicas = json.loads(proc.stdout.strip().splitlines()[-1])["replicas"]
    check(len(replicas) == 2, f"[fleet] {len(replicas)} replica reports")
    want_preds = [int(r.pred) for r in inproc]
    want_e = [float(np.float32(r.energy_j)) for r in inproc]
    for r in replicas:
        c = r["compile_cache"]
        check(c["misses"] == 0 and c["hits"] == len(_cuda.SOURCES)
              and c["dir"] == str(FLEET_DIR / "kernels"),
              f"[fleet] replica {r['replica']} compile cache {c}")
        check(r["compile_count"] == 0,
              f"[fleet] replica {r['replica']} compiled {r['compile_count']}"
              " plans")
        check(r["preds"] == want_preds and r["energies"] == want_e,
              f"[fleet] replica {r['replica']} differs from the in-process "
              "restored registry on the same requests")
        check(r["replayed"].get("fused_spike_accum", 0) > 0
              and r["replayed"].get("quant_matmul", 0) > 0,
              f"[fleet] replica {r['replica']} replayed {r['replayed']}")
        log(f"[fleet]   replica {r['replica']} on {r['device']}: "
            f"first_response_s {r['first_response_s']:.3f} (from spawn), "
            f"restore_s {r['restore_s']:.3f}, warmup_s "
            f"{r['warmup_s']:.3f}, total_s {r['total_s']:.3f}; compile "
            f"cache {c['hits']} hits / {c['misses']} misses; compile_count "
            f"{r['compile_count']}; launches (captures) "
            f"{_nonzero(r['launches'])}, replayed {_nonzero(r['replayed'])}")
    check(counted["fused_spike_accum"] > 0 and counted["quant_matmul"] > 0
          and replayed.get("fused_spike_accum", 0) > 0
          and replayed.get("quant_matmul", 0) > 0,
          f"[fleet] B1 or B2 never launched in-process: {counted}, "
          f"replayed {replayed}")
    log(f"[fleet] {kind}: 2 replicas, {replicas[0]['n']} requests each over "
        f"{len(replicas[0]['models'])} handles, bit-identical to each other "
        f"and to the in-process restored registry; fleet command {fleet_s:.1f}"
        f" s. Window launches in-process: wrapper (eager runs and captures)"
        f" B1 {counted['fused_spike_accum']}, B2 {counted['quant_matmul']};"
        f" replayed B1 {replayed.get('fused_spike_accum', 0)}, B2 "
        f"{replayed.get('quant_matmul', 0)}")
    size = sum(f.stat().st_size for f in FLEET_DIR.rglob("*") if f.is_file())
    return dict(save_s=save_s, load_s=load_s, replay_cases=cases,
                fleet_s=fleet_s, launches=counted, replayed=replayed,
                cache_dir_bytes=size,
                replicas=[{k: v for k, v in r.items()
                           if k not in ("preds", "energies")}
                          for r in replicas])


# ---------------------------------------------------------------------------
# Data-parallel execution and the paper-grid sweep
# ---------------------------------------------------------------------------

PAR_BATCHES = (1, 3, 16, 64)
PAR_WINDOWS = 3       # profiled bucket-64 windows per mesh, in turns
SWEEP_KILL_AFTER = 20  # cells the first grid call runs before it "dies"


def _meshes():
    """A 2- and a 4-way virtual mesh over the first card, and a mesh over
    every card when there is more than one."""
    import torch

    from repro_torch import parallel

    card = torch.device("cuda", 0)
    meshes = {"2x cuda:0": parallel.DataMesh((card,) * 2),
              "4x cuda:0": parallel.DataMesh((card,) * 4)}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = parallel.data_mesh()
    return meshes


def phase_parallel(params, device, kind):
    """Sharded execution on the card: ``infer_batch_sharded`` bit-equal to
    one device, ``use_mesh`` routing and ``queue_sparse``'s fallback, B1's
    launches per shard, serving over a mesh (responses bit-equal,
    ``set_mesh``, graph memory, bucket-64 readings) and the fleet registry
    restored over a mesh."""
    import numpy as np
    import torch

    from repro_torch import parallel
    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.kernels import ops
    from repro_torch.serve import (BucketPolicy, ModelRegistry, ServeRuntime,
                                   bench, load_registry)

    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    p, t = engine.to_device(params, th, device)
    meshes = _meshes()
    imgs = torch.as_tensor(make_cifar_like(64, seed=SEED + 17)[0],
                           device=device)

    # sharded == single device, every stat; the counts cover the loop
    ops.reset_launch_counts()
    cases, want_b1, want_b2 = 0, 0, 0
    for backend in ("dense", "queue_pallas"):
        for bits in (None, 8):
            c = cfg._replace(weight_bits=bits)
            for B in PAR_BATCHES:
                ref = engine.infer_batch(p, t, c, imgs[:B], backend=backend,
                                         device=device)
                want_b1 += 6 * (backend == "queue_pallas")
                want_b2 += bits == 8
                for label, mesh in meshes.items():
                    got = parallel.infer_batch_sharded(
                        p, t, c, imgs[:B], backend=backend, mesh=mesh)
                    n = parallel.mesh_size(mesh)
                    want_b1 += 6 * n * (backend == "queue_pallas")
                    want_b2 += n * (bits == 8)
                    check(torch.equal(got[0], ref[0])
                          and _stats_equal(got[1], ref[1]),
                          f"[parallel] {backend} w{bits} B={B} on {label}: "
                          "sharded differs from one device")
                    cases += 1
    counted = dict(ops.launch_counts)
    check(counted["fused_spike_accum"] == want_b1
          and counted["quant_matmul"] == want_b2,
          f"[parallel] launches {_nonzero(counted)}, expected B1 {want_b1} "
          f"(6 a shard), B2 {want_b2} (1 a shard)")
    per_call = {}
    for label, mesh in meshes.items():
        ops.reset_launch_counts()
        parallel.infer_batch_sharded(p, t, cfg, imgs, backend="queue_pallas",
                                     mesh=mesh)
        per_call[label] = ops.launch_counts["fused_spike_accum"]
        check(per_call[label] == 6 * parallel.mesh_size(mesh),
              f"[parallel] one sharded call on {label} launched B1 "
              f"{per_call[label]} times")
    log(f"[parallel] {kind}: infer_batch_sharded == infer_batch bit for bit "
        f"(logits and 5 stats) in {cases} cases: dense and queue_pallas, "
        f"fp32 and w8, B {PAR_BATCHES}, meshes {list(meshes)}; window "
        f"launches B1 {counted['fused_spike_accum']}, B2 "
        f"{counted['quant_matmul']} (as expected); B1 per bucket-64 call "
        f"{per_call} (6 a shard)")

    mesh2 = meshes["2x cuda:0"]
    ref = engine.infer_batch(p, t, cfg, imgs, backend="queue_pallas",
                             device=device)
    sparse_ref = engine.infer_batch(p, t, cfg, imgs, backend="queue_sparse",
                                    device=device)
    ops.reset_launch_counts()
    with parallel.use_mesh(mesh2):
        routed = engine.infer_batch(p, t, cfg, imgs, backend="queue_pallas")
        sparse = engine.infer_batch(p, t, cfg, imgs, backend="queue_sparse")
    use_counts = dict(ops.launch_counts)
    check(engine._batch_dispatch is None, "[parallel] use_mesh leaked")
    check(torch.equal(routed[0], ref[0]) and _stats_equal(routed[1], ref[1])
          and torch.equal(sparse[0], sparse_ref[0])
          and _stats_equal(sparse[1], sparse_ref[1]),
          "[parallel] use_mesh changed a result")
    check(use_counts["fused_spike_accum"] == 12
          and use_counts["fused_spike_accum_sparse"] == 6,
          f"[parallel] use_mesh launches {_nonzero(use_counts)}: expected "
          "B1 12 (routed, 2 shards) and B3 6 (queue_sparse, local)")
    log(f"[parallel] use_mesh(2x cuda:0): engine.infer_batch routed "
        f"(queue_pallas, B1 {use_counts['fused_spike_accum']}) and "
        f"queue_sparse on the local runner (B3 "
        f"{use_counts['fused_spike_accum_sparse']}), both == one device")

    # serving: one registry per mesh, the mesh given to the runtime
    requests, _ = make_cifar_like(N_REQUESTS, seed=SEED + 19)
    imgs64 = requests[:64]
    regs, runtimes, graph_mib, answers = {}, {}, {}, {}
    handle_names = (("cifar10-fp32", None), ("cifar10-w8", 8))
    for label, mesh in [("no mesh", None)] + list(meshes.items()):
        gc.collect()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        reg = ModelRegistry(device=device)
        for name, bits in handle_names:
            reg.register(name, params, th, cfg._replace(weight_bits=bits))
        rt = ServeRuntime(reg, BucketPolicy(BUCKETS), mesh=mesh)
        for name, _ in handle_names:
            reg.get(name).warmup(BUCKETS)
        torch.cuda.synchronize()
        graph_mib[label] = (torch.cuda.memory_reserved() - reserved0) / 2**20
        if mesh is not None:
            for name, bits in handle_names:
                h = reg.get(name)
                n = parallel.mesh_size(mesh) if h._bucket_sharded(64) else 1
                check(h.plan_launches[64]["fused_spike_accum"] == 6 * n
                      and h.plan_launches[64]["quant_matmul"]
                      == n * (bits == 8)
                      and h.plan_launches[1]["fused_spike_accum"] == 6,
                      f"[parallel] {name} on {label}: captured launches "
                      f"{h.plan_launches}")
        regs[label], runtimes[label] = reg, rt
        answers[label] = {name: bench.closed_loop(rt, name, requests)
                          for name, _ in handle_names}
    base = answers["no mesh"]
    for label in meshes:
        for name, _ in handle_names:
            check(_responses_equal(base[name].responses,
                                   answers[label][name].responses),
                  f"[parallel] {name} served on {label} answered "
                  "differently from the unsharded runtime")
    rps = {label: {name: a[name].throughput_rps for name in a}
           for label, a in answers.items()}
    log(f"[parallel] serving: {N_REQUESTS} requests a handle, closed loop, "
        f"buckets {BUCKETS}: responses (logits, stats, energies) on every "
        f"mesh == the unsharded runtime's; req/s {rps}; the graphs reserve "
        "MiB " + ", ".join(f"{k} {v:.1f}" for k, v in graph_mib.items()))

    # bucket-64 readings, the meshes in turns (one card: shards of a
    # virtual mesh share its SMs, so these are readings, not a gain)
    order = ["no mesh"] + list(meshes)
    windows = {label: [] for label in order}
    for i in range(PAR_WINDOWS):
        for label in (order if i % 2 == 0 else order[::-1]):
            h = regs[label].get("cifar10-fp32")
            windows[label].append(
                profile_window(lambda h=h: h.run_bucket(imgs64, 64)))
    readings = {label: {k: spread([w[k] for w in ws]) for k in WINDOW_KEYS}
                for label, ws in windows.items()}
    for label, o in readings.items():
        mesh = meshes.get(label)
        many = mesh is not None and len(set(mesh.devices)) > 1
        note = ("device busy sums the cards, so 1 - busy / wall is no idle "
                "share" if many else "the shards of a virtual mesh share one "
                "card's SMs: a reading, not a gain")
        log(f"[parallel] bucket 64 fp32 replay, {label}: wall "
            f"{fmt_spread(o['unprofiled_wall_ms'])} ms, device busy "
            f"{fmt_spread(o['device_busy_ms'])} ms, idle share "
            f"{fmt_spread(o['idle_share'])} ({PAR_WINDOWS} windows x 5 "
            f"calls, in turns; {note})")

    # set_mesh on a live registry: plans dropped, every bucket re-captured
    reg = regs["no mesh"]
    before = {name: reg.get(name).compile_count for name, _ in handle_names}
    reg.set_mesh(mesh2)
    for name, _ in handle_names:
        h = reg.get(name)
        check(h.cached_buckets() == (), f"[parallel] set_mesh kept {name}'s "
              f"plans {h.cached_buckets()}")
        h.warmup(BUCKETS)
        check(h.compile_count == before[name] + len(BUCKETS),
              f"[parallel] {name}: compile_count {before[name]} -> "
              f"{h.compile_count} after set_mesh + warmup")
        res = bench.closed_loop(runtimes["no mesh"], name, requests)
        check(_responses_equal(base[name].responses, res.responses),
              f"[parallel] {name} after set_mesh answered differently")
    log(f"[parallel] set_mesh(2x cuda:0) on the live registry dropped every "
        f"plan; warmup re-captured {len(BUCKETS)} a handle (compile_count "
        f"+{len(BUCKETS)}), answers unchanged")

    # the fleet phase's registry restored over a mesh: no plan at load
    restored = load_registry(str(FLEET_DIR / "registry"), device=device,
                             mesh=mesh2)
    rt = ServeRuntime(restored, BucketPolicy(BUCKETS))
    for name, _ in handle_names:
        h = restored.get(name)
        check(h.mesh == mesh2 and h.cached_buckets() == ()
              and h.compile_count == 0,
              f"[parallel] {name} restored over a mesh built plans at load")
        res = bench.closed_loop(rt, name, requests)
        check(_responses_equal(base[name].responses, res.responses),
              f"[parallel] {name} restored over a mesh answered differently")
        check(h.compile_count == len(h.cached_buckets()) >= 1,
              f"[parallel] {name}: compile_count {h.compile_count}")
    log(f"[parallel] load_registry(fleet registry, mesh=2x cuda:0): no plan "
        f"at load, buckets built on first use "
        f"({restored.get('cifar10-fp32').cached_buckets()}), answers == the "
        "unsharded runtime's")
    del regs, runtimes, restored, rt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(meshes=list(meshes), cases=cases, launches=counted,
                b1_per_bucket64_call=per_call, use_mesh_launches=use_counts,
                serve_rps=rps, graph_mib=graph_mib, bucket64=readings,
                windows=windows)


def phase_sweep(kind):
    """The paper grid on the card: 48 cells, killed after
    ``SWEEP_KILL_AFTER`` and resumed with nothing computed twice, then a
    pure resume; one (dataset, queue_pallas) pair again on a 2-way mesh
    (rows == the grid's); the converted-vs-direct grid on MNIST."""
    import math

    import torch

    from repro_torch import parallel
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.study import (StudyCache, reset_stage_counts, stages,
                                   stage_counts)
    from repro_torch.study.sweep import (QUICK_PRICING, markdown_grid,
                                         paper_grid, run_sweep)

    root = ROOT / "chiprun_out" / "sweep"
    shutil.rmtree(root, ignore_errors=True)
    cache_dir = str(root / "cache")
    cells = paper_grid()
    check(len(cells) == 48, f"[sweep] the full grid has {len(cells)} cells")

    def quiet(*_):
        pass

    def b1_per_collect(spec):
        plan = engine.compile_plan(spec.net, spec.input_hw, spec.input_c)
        return ((len(plan.convs) - (spec.input_mode == "analog"))
                * math.ceil(spec.n_eval / spec.batch))

    want_b1 = sum(b1_per_collect(c) for c in cells
                  if c.backend == "queue_pallas" and c.compressed
                  and c.vmem_resident and c.weight_bits == 8)
    ops.reset_launch_counts()
    reset_stage_counts()
    t0 = time.perf_counter()
    killed = run_sweep(cells, out_dir=str(root), cache_dir=cache_dir,
                       max_cells=SWEEP_KILL_AFTER, log=quiet)
    first = dict(stage_counts)
    reset_stage_counts()     # a new StudyCache below: a new process's view
    done = run_sweep(cells, out_dir=str(root), cache_dir=cache_dir, log=quiet)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    second = dict(stage_counts)
    launches = dict(ops.launch_counts)
    check(killed["executed"] == SWEEP_KILL_AFTER and not killed["complete"],
          f"[sweep] the killed call ran {killed['executed']} cells")
    check(done["complete"] and done["resumed"] == SWEEP_KILL_AFTER
          and done["executed"] == 48 - SWEEP_KILL_AFTER,
          f"[sweep] the resume: {done['resumed']} resumed, "
          f"{done['executed']} executed")
    total = {k: first.get(k, 0) + second.get(k, 0)
             for k in set(first) | set(second)}
    check(total == {"train": 3, "convert": 3, "collect": 6},
          f"[sweep] stage executions {first} + {second}: a stage ran twice "
          "or not at all")
    check(launches["fused_spike_accum"] == want_b1,
          f"[sweep] B1 launched {launches['fused_spike_accum']} times in the "
          f"grid, expected {want_b1} (the queue_pallas collects)")
    reset_stage_counts()
    again = run_sweep(cells, out_dir=str(root), cache_dir=cache_dir, log=quiet)
    check(again["resumed"] == 48 and again["executed"] == 0
          and dict(stage_counts) == {},
          f"[sweep] a pure resume executed {again['executed']} cells, "
          f"stages {dict(stage_counts)}")
    timing = done["timing"]
    elapsed = [r["elapsed_s"] for r in done["cells"]]
    log(f"[sweep] {kind}: the full paper grid, 48 cells (3 datasets x dense,"
        f" queue_pallas x 8 pricing variants), killed after "
        f"{SWEEP_KILL_AFTER} and resumed: {grid_s:.1f} s; stage executions "
        f"killed call {first}, resume {second} (nothing twice), a third "
        f"call resumed all 48 and ran nothing; seconds a cell p50 "
        f"{timing['p50_s']:.3f}, p95 {timing['p95_s']:.3f}, max "
        f"{timing['max_s']:.3f}, sum {timing['total_s']:.1f}; "
        f"{48 / 6:.0f} cells per collect; B1 {launches['fused_spike_accum']}"
        " launches in the window (as expected)")
    grid_md = markdown_grid(done["cells"])
    for line in grid_md.splitlines()[2:10]:
        log(f"[sweep]   {line}")

    # a cached train lookup regenerates and hashes the training images
    train_hit_s = {}
    cache = StudyCache(dir=cache_dir)
    for ds in ("mnist", "svhn", "cifar10"):
        spec = next(c for c in cells if c.dataset == ds)
        stages.train(spec, cache=cache)            # disk hit into memory
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages.train(spec, cache=cache)            # memory hit
        torch.cuda.synchronize()
        train_hit_s[ds] = time.perf_counter() - t1
    log(f"[sweep] a cached train lookup (memory hit: images regenerated and "
        f"hashed for the key) takes s {train_hit_s}; 16 cells a dataset pay "
        f"it: {16 * sum(train_hit_s.values()):.2f} s of the grid")

    # one pair again, collected on a 2-way mesh over train/convert on disk
    mesh2 = _meshes()["2x cuda:0"]
    pair = [c for c in cells
            if c.dataset == "mnist" and c.backend == "queue_pallas"]
    ops.reset_launch_counts()
    reset_stage_counts()
    sharded = run_sweep(
        pair, out_dir=str(root / "mesh"), mesh=mesh2, fresh=True, log=quiet,
        cache=StudyCache(dir=cache_dir, disk_kinds=("train", "convert")))
    mesh_launches = ops.launch_counts["fused_spike_accum"]
    check(dict(stage_counts) == {"collect": 1},
          f"[sweep] the sharded pair ran stages {dict(stage_counts)}")
    check(mesh_launches == 2 * b1_per_collect(pair[0]),
          f"[sweep] the sharded collect launched B1 {mesh_launches} times")
    by_id = {r["cell_id"]: r for r in done["cells"]}
    for r in sharded["cells"]:
        a = {k: v for k, v in r.items() if k != "elapsed_s"}
        b = {k: v for k, v in by_id[r["cell_id"]].items() if k != "elapsed_s"}
        check(a == b, f"[sweep] cell {r['cell_id']} collected on a 2-way "
              "mesh differs from the grid's row")
    log(f"[sweep] mnist/queue_pallas ({len(pair)} cells) again with "
        f"fresh=True on mesh 2x cuda:0 over train/convert on disk: one "
        f"collect, B1 {mesh_launches} launches (2 shards x event stages x "
        f"batches), rows == "
        f"the grid's (elapsed_s aside); {sharded['timing']['total_s']:.2f} s")

    # the converted-vs-direct grid
    dcells = paper_grid(direct=True, datasets=("mnist",),
                        pricing=QUICK_PRICING)
    reset_stage_counts()
    t1 = time.perf_counter()
    direct = run_sweep(dcells, out_dir=str(root / "direct"),
                       cache_dir=cache_dir, log=quiet)
    direct_s = time.perf_counter() - t1
    dmd = markdown_grid(direct["cells"])
    pairs = dmd.split("## Converted vs direct")[-1]
    check(direct["complete"] and "## Converted vs direct" in dmd
          and pairs.count("| mnist |") == 4,
          "[sweep] the direct grid lacks its pairing section")
    log(f"[sweep] direct grid ({len(dcells)} cells, mnist) {direct_s:.1f} s, "
        f"stages {dict(stage_counts)}:")
    for line in pairs.strip().splitlines():
        log(f"[sweep]   {line}")
    shutil.rmtree(cache_dir, ignore_errors=True)   # the cells and reports stay
    return dict(grid_s=grid_s, killed_stages=first, resume_stages=second,
                timing={k: v for k, v in timing.items() if k != "by_cell"},
                elapsed_s=elapsed, launches=launches, train_hit_s=train_hit_s,
                sharded_pair_b1=mesh_launches,
                sharded_pair_s=sharded["timing"]["total_s"],
                direct_s=direct_s, grid_md=grid_md, direct_md=dmd)


# ---------------------------------------------------------------------------
# The LM stack (models/, training/train_loop.py, data/pipeline.py)
# ---------------------------------------------------------------------------

LM_PROMPT = (4, 512)        # prompts x tokens from TokenStream
LM_DECODE = 16              # greedy decode steps after the prefill
LM_TRAIN = (8, 512)         # train batch x tokens
LM_TRAIN_STEPS = 4
LM_TRAIN_LAYERS = 2         # training's depth cut (full width)
LM_CORPUS = 200_000         # TokenStream corpus tokens
LM_ATOL = 0.15              # tests/test_models.py's prefill/decode == forward
LM_SMOKE_ULPS = 8           # card vs CPU, in bf16 ulps of the largest logit


def lm_configs():
    """The configurations the lm phase runs, spelled out with the port's
    ``ArchConfig``: Qwen1.5-MoE-A2.7B's dimensions as
    ``tests/_smoke_archs.py:95-103`` (``FULL["moe-14b"]``) gives them, and
    the nine smoke configurations of ``tests/_smoke_archs.py`` (``SMOKES``,
    one a distinct path of the stack)."""
    from repro_torch.models.model import ArchConfig
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.ssm import MambaConfig

    full = ArchConfig(
        name="moe-14b", family="moe", n_layers=24, d_model=2048, n_heads=16,
        kv_heads=16, d_ff=0, vocab=151936, act="swiglu", rope_theta=1e6,
        moe=MoEConfig(n_experts=60, top_k=4, expert_d_ff=1408,
                      shared_d_ff=5632, every_k_layers=1),
        microbatches=4, remat="full",
        source="Qwen1.5-MoE-A2.7B (tests/_smoke_archs.py:95-103)")
    smokes = {
        "dense-tied": ArchConfig(
            name="dense-tied-smoke", family="dense", n_layers=2, d_model=64,
            n_heads=4, kv_heads=2, d_ff=128, vocab=256, act="swiglu",
            tie_embeddings=True, remat="none"),
        "dense-untied": ArchConfig(
            name="dense-untied-smoke", family="dense", n_layers=2,
            d_model=64, n_heads=4, kv_heads=2, d_ff=128, vocab=128,
            act="swiglu", remat="none"),
        "dense-gelu-ln": ArchConfig(
            name="dense-gelu-ln-smoke", family="dense", n_layers=2,
            d_model=64, n_heads=4, kv_heads=2, d_ff=128, vocab=128,
            act="gelu", norm="layernorm", remat="none"),
        "dense-geglu-hd": ArchConfig(
            name="dense-geglu-hd-smoke", family="dense", n_layers=2,
            d_model=64, n_heads=2, kv_heads=2, head_dim=48, d_ff=128,
            vocab=128, act="geglu", tie_embeddings=True, remat="none"),
        "moe": ArchConfig(
            name="moe-smoke", family="moe", n_layers=2, d_model=64,
            n_heads=4, kv_heads=4, d_ff=0, vocab=128, act="swiglu",
            moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=96,
                          shared_d_ff=96, every_k_layers=1), remat="none"),
        "hybrid": ArchConfig(
            name="hybrid-smoke", family="hybrid", n_layers=8, d_model=64,
            n_heads=4, kv_heads=2, d_ff=96, vocab=128, act="swiglu",
            rope_theta=0.0,
            block_pattern=("mamba", "mamba", "mamba", "mamba", "attn",
                           "mamba", "mamba", "mamba"),
            moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=96,
                          every_k_layers=2),
            mamba=MambaConfig(d_inner=128, d_state=8, d_conv=4),
            sub_quadratic=True, remat="none"),
        "xlstm": ArchConfig(
            name="xlstm-smoke", family="ssm", n_layers=2, d_model=64,
            n_heads=2, kv_heads=2, d_ff=0, vocab=128, act="gelu",
            rope_theta=0.0, tie_embeddings=True,
            block_pattern=("mlstm", "slstm"), sub_quadratic=True,
            remat="none"),
        "enc-dec-audio": ArchConfig(
            name="enc-dec-audio-smoke", family="audio", n_layers=2,
            d_model=64, n_heads=4, kv_heads=4, d_ff=128, vocab=128,
            act="relu", norm="layernorm", rope_theta=0.0, enc_dec=True,
            n_enc_layers=2, frontend="audio", remat="none"),
        "vlm": ArchConfig(
            name="vlm-smoke", family="vlm", n_layers=2, d_model=64,
            n_heads=4, kv_heads=2, d_ff=128, vocab=128, act="swiglu",
            frontend="vision", remat="none"),
    }
    return full, smokes


class DispatchRecorder:
    """Wraps ``kernels.ops.moe_gather`` (the MoE layer's B6 call) while a
    ``with`` block runs: each dispatch's buffer is held bit for bit against
    ``moe_gather_plain`` on the same words, and each call's routing is
    recorded as a (T, experts) map of the assignments the capacity queues
    kept (plain launches no B6, so the launch counts stay the path's
    own)."""

    def __init__(self, n_experts, keep_first=False):
        self.n_experts, self.keep_first = n_experts, keep_first
        self.assign, self.first = [], None

    @property
    def calls(self):
        return len(self.assign)

    def __enter__(self):
        import torch

        from repro_torch.kernels import moe_gather as mg
        from repro_torch.kernels import ops

        self._ops, self._orig = ops, ops.moe_gather

        def wrapped(x, idx):
            out = self._orig(x, idx)
            with torch.no_grad():
                check(torch.equal(out, mg.moe_gather_plain(x, idx)),
                      f"lm: B6 dispatch {self.calls} differs from "
                      "moe_gather_plain on the same words")
                cap = idx.shape[0] // self.n_experts
                expert = torch.arange(idx.shape[0], device=idx.device) // cap
                live = idx >= 0
                a = torch.zeros((x.shape[0], self.n_experts),
                                dtype=torch.bool, device=idx.device)
                a[idx[live].long(), expert[live]] = True
                self.assign.append(a)
                if self.keep_first and self.first is None:
                    self.first = (x.detach().clone(), idx.clone())
            return out

        ops.moe_gather = wrapped
        return self

    def __exit__(self, *exc):
        self._ops.moe_gather = self._orig


def _sync_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _tree_to(tree, device):
    from repro_torch.training.optimizer import _map

    return _map(lambda t: t.to(device), tree)


def lm_serve(full, device):
    """Full width, full depth: prefill 4 prompts of 512 tokens from
    TokenStream, greedy-decode 16 tokens; B6's dispatch buffers and
    launches; prefill + decode against ``forward``."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import model as TM
    from repro_torch.training.optimizer import _leaves

    B, S = LM_PROMPT
    L = full.n_layers
    E = full.moe.e_pad
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED)
    (params, _), init_ms = _sync_ms(lambda: TM.init_model(gen, full,
                                                          device=device))
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == full.param_count() + (2 * L + 1) * full.d_model,
          f"lm: {n_params} parameters, the reference's param_count "
          f"{full.param_count()} + the norms'")
    prompt = TokenStream(full.vocab, S, B, seed=SEED, corpus_tokens=LM_CORPUS,
                         device=device).batch(0)["tokens"]
    check(prompt.shape == (B, S) and prompt.dtype == torch.int32,
          "lm: TokenStream batch shape")
    max_seq = S + LM_DECODE + 1     # + the profiled decode step's entry
    with torch.no_grad():
        # B6's buffers of one prefill held against plain; the first layer's
        # dispatch kept for the kernel row
        with DispatchRecorder(E, keep_first=True) as rec:
            TM.prefill(params, full, {"tokens": prompt}, max_seq=max_seq)
        check(rec.calls == L, f"lm: {rec.calls} B6 dispatches in the "
              f"checked prefill, expected {L}")
        dropped = [B * S * full.moe.top_k - int(a.sum()) for a in rec.assign]
        b6_x, b6_idx = rec.first
        del rec
        # the path as a user calls it, timed
        ops.reset_launch_counts()
        (lp, caches), prefill_ms = _sync_ms(lambda: TM.prefill(
            params, full, {"tokens": prompt}, max_seq=max_seq))
        prefill_launches = ops.launch_counts["moe_gather"]
        check(prefill_launches == L, f"lm: B6 launched {prefill_launches} "
              f"times in the prefill, expected {L}")
        check(bool(torch.isfinite(lp).all()), "lm: prefill logits not finite")
        toks = [torch.argmax(lp, -1).to(torch.int32)]
        step_ms, step_launches = [], []
        for _ in range(LM_DECODE):
            ops.reset_launch_counts()
            (ld, caches), ms = _sync_ms(lambda: TM.decode_step(
                params, full, caches, {"tokens": toks[-1][:, None]}))
            step_launches.append(ops.launch_counts["moe_gather"])
            step_ms.append(ms)
            check(bool(torch.isfinite(ld).all()),
                  "lm: decode logits not finite")
            toks.append(torch.argmax(ld, -1).to(torch.int32))
        check(all(n == L for n in step_launches),
              f"lm: B6 launches per decode step {step_launches}, expected "
              f"{L} each")
        peak = torch.cuda.max_memory_allocated()

        def one_decode_step():
            TM.decode_step(params, full, caches, {"tokens": toks[-1][:, None]})
            torch.cuda.synchronize()

        decode_prof = profile_window(one_decode_step, reps=2)
        del caches
        holds = lm_vs_forward(params, full, prompt, max_seq)
    decode_ms = sum(step_ms) / len(step_ms)
    out = dict(
        params=n_params, param_bytes=n_params * 4, init_ms=init_ms,
        prefill_ms=prefill_ms, prefill_tokens=B * S,
        prefill_tok_s=B * S / prefill_ms * 1e3,
        decode_ms_per_step=decode_ms, decode_step_ms=step_ms,
        decode_tok_s=B / decode_ms * 1e3,
        b6_prefill_launches=prefill_launches,
        b6_decode_launches=step_launches, peak_bytes=peak,
        prefill_assignments_dropped_by_layer=dropped, vs_forward=holds,
        decode_profile=decode_prof)
    log(f"[lm] serve {full.name} (Qwen1.5-MoE-A2.7B dims, {L} layers, "
        f"{n_params:,} fp32 parameters, {n_params * 4 / 1e9:.1f} GB; init "
        f"{init_ms:.0f} ms on the card): prefill {B}x{S} {prefill_ms:.1f} ms "
        f"({out['prefill_tok_s']:.0f} tok/s), decode {decode_ms:.2f} ms a "
        f"step of {B} tokens ({out['decode_tok_s']:.1f} tok/s), peak "
        f"{peak / 2**30:.2f} GiB")
    log(f"[lm]   profiled decode step: wall {decode_prof['wall_ms']:.1f} ms,"
        f" device busy {decode_prof['device_busy_ms']:.1f} ms, idle share "
        f"{decode_prof['idle_share']:.3f}, {decode_prof['device_ops']} device "
        f"ops; top {[(r['name'][:40], round(r['ms'], 2)) for r in decode_prof['top'][:4]]}")
    log(f"[lm]   B6 launches: prefill {prefill_launches}, decode steps "
        f"{sorted(set(step_launches))} (expected {L} each); the {L} "
        f"dispatch buffers of a prefill == moe_gather_plain bit for bit; "
        f"assignments the capacity queues dropped, by layer: {dropped}")
    for h in holds:
        log(f"[lm]   vs forward after {h['new_tokens']} new tokens "
            f"(no-drop capacity): {h['rows_held']}/{B} rows whose compared "
            f"token was routed alike at every layer held, max |err| "
            f"{h['max_abs_err_held']:.4f} (tolerance {LM_ATOL}, "
            f"tests/test_models.py's); by row {h['max_abs_err_rows']}, "
            f"layers routed apart by row {h['layers_routed_apart_rows']}")
    del params, lp
    return out, (b6_x, b6_idx)


def lm_vs_forward(params, full, prompt, max_seq):
    """prefill + decode against ``forward`` on the extended sequence (as
    ``tests/test_models.py::test_decode_matches_forward_dense_arch``): the
    prompt's last logits, the first decode step's and the last's. The
    capacity queues are sized so that nothing drops (capacity_factor =
    experts / top_k): with drops, a forward over the longer sequence and a
    4-token decode step fill the queues differently, which is the
    reference's semantics and another computation. The combine's
    ``index_add_`` runs deterministically here. Routing words first: a row
    is held where its compared token was routed alike at every layer in
    both runs (products of other shapes round an ulp apart, and an ulp can
    flip a routing decision)."""
    import dataclasses

    import torch

    from repro_torch.models import model as TM

    B, S = prompt.shape
    E = full.moe.e_pad
    cfg = dataclasses.replace(full, moe=full.moe._replace(
        capacity_factor=full.moe.n_experts / full.moe.top_k))
    # index_add_ without atomics for these runs (PyTorch's deterministic
    # path), so that one computation run twice rounds alike
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _vs_forward(params, cfg, prompt, max_seq, B, S, E)
    finally:
        torch.use_deterministic_algorithms(False)


def _vs_forward(params, cfg, prompt, max_seq, B, S, E):
    import torch

    from repro_torch.models import model as TM

    with DispatchRecorder(E) as rec:
        lp, caches = TM.prefill(params, cfg, {"tokens": prompt},
                                max_seq=max_seq)
    routes, logits, toks = [[a.reshape(B, S, E)[:, -1] for a in rec.assign]], \
        [lp], [torch.argmax(lp, -1).to(torch.int32)]
    for _ in range(LM_DECODE):
        with DispatchRecorder(E) as drec:
            ld, caches = TM.decode_step(params, cfg, caches,
                                        {"tokens": toks[-1][:, None]})
        routes.append(drec.assign)
        logits.append(ld)
        toks.append(torch.argmax(ld, -1).to(torch.int32))
    del caches
    holds = []
    for n_new in (0, 1, LM_DECODE):
        seq = torch.cat([prompt] + [t[:, None] for t in toks[:n_new]], 1)
        with DispatchRecorder(E) as frec:
            lf, _ = TM.forward(params, cfg, {"tokens": seq}, remat=False)
        ref = lf[:, -1, : cfg.vocab].float()
        del lf
        last = [a.reshape(B, seq.shape[1], E)[:, -1] for a in frec.assign]
        apart = torch.zeros(B, dtype=torch.int32, device=prompt.device)
        for x, y in zip(last, routes[n_new]):
            apart += (x != y).any(-1).to(torch.int32)
        held_rows = apart == 0
        err = (logits[n_new] - ref).abs().amax(1)
        held = int(held_rows.sum())
        worst = float(err[held_rows].max()) if held else float("nan")
        holds.append(dict(new_tokens=n_new, rows_held=held,
                          max_abs_err_held=worst,
                          max_abs_err_rows=[round(float(e), 4) for e in err],
                          layers_routed_apart_rows=apart.tolist()))
    for h in holds:
        check(h["rows_held"] == 0 or h["max_abs_err_held"] <= LM_ATOL,
              f"lm: prefill/decode vs forward after {h['new_tokens']} new "
              f"tokens: max error {h['max_abs_err_held']} > {LM_ATOL}")
    check(sum(h["rows_held"] for h in holds) > 0,
          f"lm: no row's compared token routed alike in prefill/decode and "
          f"forward: {holds}")
    return holds


def lm_train(full, device):
    """Full width, depth cut to LM_TRAIN_LAYERS: LM_TRAIN_STEPS steps of
    ``make_train_step`` at 8 x 512 tokens from TokenStream (microbatches 4,
    remat full), microbatches 4 against 1 on one batch, an int8 step held
    against the quantizer written out by hand, and one profiled step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import model as TM
    from repro_torch.training import train_loop as TTL
    from repro_torch.training.optimizer import _leaves, global_norm

    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    m = cfg.microbatches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    params, _ = TM.init_model(gen, cfg, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    stream = TokenStream(cfg.vocab, LM_TRAIN[1], LM_TRAIN[0], seed=SEED + 1,
                         corpus_tokens=LM_CORPUS, device=device)
    step = TTL.make_train_step(cfg, warmup=0)
    state = TTL.init_state(params)
    del params
    losses, step_ms, launches = [], [], []
    for i in range(LM_TRAIN_STEPS):
        batch = stream.batch(i)
        ops.reset_launch_counts()
        (state, met), ms = _sync_ms(lambda: step(state, batch))
        launches.append(ops.launch_counts["moe_gather"])
        step_ms.append(ms)
        losses.append(float(met["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(
            met["grad_norm"])), f"lm: train step {i} loss {losses[-1]}")
    # one launch a microbatch a layer in the forward, and once more when
    # the checkpointed period is recomputed in the backward (remat full)
    want = m * LM_TRAIN_LAYERS * 2
    check(all(n == want for n in launches),
          f"lm: B6 launches per train step {launches}, expected {want}")
    # microbatches 4 against 1 compute one mean gradient only where the
    # capacity queues drop nothing: a microbatch's queues hold a quarter of
    # the tokens at a quarter of the capacity, and which tokens drop
    # differs. So this check sizes them for no drop (capacity_factor =
    # experts / top_k), as lm_vs_forward does
    nodrop = dataclasses.replace(cfg, moe=cfg.moe._replace(
        capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    batch = stream.batch(LM_TRAIN_STEPS)
    s4, m4 = TTL.make_train_step(nodrop, warmup=0)(state, batch)
    p4 = s4.params
    del s4
    s1, m1 = TTL.make_train_step(dataclasses.replace(nodrop, microbatches=1),
                                 warmup=0)(state, batch)
    micro_loss = abs(float(m4["loss"]) - float(m1["loss"]))
    micro_param = max(float((a - b).abs().max())
                      for a, b in zip(_leaves(p4), _leaves(s1.params)))
    del s1, p4
    check(micro_loss < 5e-3 and micro_param < 5e-3,
          f"lm: microbatches {m} vs 1: loss {micro_loss}, params "
          f"{micro_param} (tests/test_training.py's 5e-3)")
    # int8: the step's compressed gradients against the quantizer written
    # out here, leaf by leaf, and the step's grad_norm against theirs
    seen = {}
    orig = TTL.compress_decompress

    def by_hand_checked(grads):
        out = orig(grads)
        for g, dq in zip(_leaves(grads), _leaves(out)):
            s = torch.clamp(g.float().abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g.float() / s), -128, 127)
            check(torch.equal(dq, (q.to(torch.int8).float() * s).to(g.dtype)),
                  "lm: int8 step's gradients != the quantizer by hand")
        seen["norm"] = global_norm(out)
        seen["leaves"] = len(_leaves(out))
        cpu = orig({"w": _leaves(grads)[0].cpu()})["w"]
        seen["cpu_equal"] = torch.equal(cpu, _leaves(out)[0].cpu())
        return out

    TTL.compress_decompress = by_hand_checked
    try:
        s8, m8 = TTL.make_train_step(cfg, warmup=0, grad_compression="int8")(
            state, batch)
    finally:
        TTL.compress_decompress = orig
    check(seen and torch.equal(m8["grad_norm"], seen["norm"])
          and seen["cpu_equal"] and np.isfinite(float(m8["loss"])),
          "lm: the int8 step did not apply compress_decompress as written")
    del s8
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(state, batch)
        torch.cuda.synchronize()

    prof = profile_window(one_step, reps=1)
    out = dict(layers=cfg.n_layers, params=n_params, losses=losses,
               step_ms=step_ms, b6_launches_per_step=launches,
               micro_loss_diff=micro_loss, micro_param_diff=micro_param,
               int8_leaves=seen["leaves"], peak_bytes=peak, profile=prof)
    log(f"[lm] train {cfg.name} at full width, depth cut to {cfg.n_layers} "
        f"layers ({n_params:,} parameters), {LM_TRAIN[0]}x{LM_TRAIN[1]} "
        f"tokens a step, microbatches {m}, remat {cfg.remat}: ms a step "
        f"{fmt_spread(spread(step_ms), '{:.1f}')}, losses "
        f"{[round(x, 4) for x in losses]}, B6 launches a step {launches}, "
        f"peak {peak / 2**30:.2f} GiB")
    log(f"[lm]   microbatches {m} vs 1 on one batch (no-drop capacity): "
        f"|loss diff| "
        f"{micro_loss:.2e}, max |param diff| {micro_param:.2e} (< 5e-3); "
        f"int8 step: {seen['leaves']} leaves == the quantizer by hand, "
        f"grad_norm == theirs, card == CPU on the first leaf")
    log(f"[lm]   profiled step: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_busy_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}, {prof['device_ops']} device ops; top "
        f"{[(r['name'][:40], round(r['ms'], 2)) for r in prof['top'][:4]]}")
    del state
    return out


def _smoke_batch(cfg, B=2, S=16, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = {}
    if cfg.enc_dec:
        b["src_embeddings"] = torch.from_numpy(
            rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)).bfloat16()
        b["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    elif cfg.frontend != "none":
        b["embeddings"] = torch.from_numpy(
            rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)).bfloat16()
    else:
        b["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    b["labels"] = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    return b


def lm_smokes(smokes, device):
    """The nine smoke configurations on the card, each against the port's
    own CPU run of the same parameters: ``forward``, one train step's loss,
    ``prefill`` and ``decode_step`` logits within LM_SMOKE_ULPS bf16 ulps of
    the largest (cuBLAS and the combine's atomics round apart from the
    CPU), at the positions whose routing words agree; B6 once a MoE layer
    in the forward."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as TM
    from repro_torch.models.transformer import _use_moe
    from repro_torch.training import train_loop as TTL
    from repro_torch.training.optimizer import _leaves

    rows = {}
    for name, cfg in smokes.items():
        params, _ = TM.init_model(torch.Generator().manual_seed(SEED), cfg,
                                  device="cpu")
        batch = _smoke_batch(cfg)
        B, S = batch["labels"].shape
        pf = {k: v for k, v in batch.items() if k != "labels"}
        dec = {"tokens": torch.zeros((B, 1), dtype=torch.int32)}
        if cfg.enc_dec:
            dec["enc_out"] = torch.from_numpy(np.random.default_rng(1).normal(
                size=(B, S, cfg.d_model)).astype(np.float32)).bfloat16()
        res = {}
        for dev in ("cpu", device):
            p = _tree_to(params, dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            recs = []

            def recorder():
                recs.append(DispatchRecorder(cfg.moe.e_pad) if cfg.moe
                            else contextlib.nullcontext())
                return recs[-1]

            with torch.no_grad():
                ops.reset_launch_counts()
                with recorder():
                    lf, _ = TM.forward(p, cfg, b, remat=False)
                n_b6 = ops.launch_counts["moe_gather"]
                with recorder():
                    lp, c = TM.prefill(p, cfg, {k: v.to(dev) for k, v in
                                                pf.items()}, max_seq=S + 4)
                with recorder():
                    ld, _ = TM.decode_step(p, cfg, c, {
                        k: v.to(dev) for k, v in dec.items()})
            st, met = TTL.make_train_step(cfg, warmup=0)(TTL.init_state(p), b)
            res[str(dev)] = dict(
                forward=lf.float().cpu(), prefill=lp.cpu(), decode=ld.cpu(),
                loss=float(met["loss"]), b6=n_b6,
                routes=[[a.cpu() for a in r.assign] if cfg.moe else []
                        for r in recs],
                finite=all(bool(torch.isfinite(t).all())
                           for t in _leaves(st.params)))
        cpu, card = res["cpu"], res[str(device)]
        # routing words first: a position is compared where it and every
        # earlier position of its row were routed alike at every MoE layer
        # (causal mixers: nothing later reaches it)
        clean = torch.ones((B, S), dtype=torch.bool)
        for a, b_ in zip(cpu["routes"][0], card["routes"][0]):
            clean &= (a == b_).all(-1).reshape(B, S)
        clean = torch.cumprod(clean.to(torch.int32), 1).bool()
        dec_ok = clean[:, -1].clone()
        for a, b_ in zip(cpu["routes"][2], card["routes"][2]):
            dec_ok &= (a == b_).all(-1)
        masks = {"forward": clean, "prefill": clean[:, -1], "decode": dec_ok}
        errs = {}
        for k in ("forward", "prefill", "decode"):
            ref, got, m = cpu[k], card[k], masks[k]
            tol = LM_SMOKE_ULPS * 2.0 ** -8 * float(ref.abs().max())
            err = float((got - ref).abs()[m].max()) if m.any() else 0.0
            errs[k] = err
            check(err <= tol, f"lm: smoke {name} {k} on the card vs CPU: "
                  f"{err} > {tol}")
        loss_err = abs(card["loss"] - cpu["loss"])
        check(loss_err <= 2.0 ** -8 * abs(cpu["loss"]) and card["finite"],
              f"lm: smoke {name} train step: loss {card['loss']} vs CPU "
              f"{cpu['loss']}")
        n_moe = sum(_use_moe(cfg, i) for i in range(cfg.n_layers))
        check(card["b6"] == n_moe,
              f"lm: smoke {name}: B6 launched {card['b6']} times in the "
              f"forward, expected {n_moe}")
        rows[name] = dict(max_abs_err=errs, loss=card["loss"],
                          loss_cpu=cpu["loss"], b6_launches=card["b6"],
                          positions_compared=int(clean.sum()),
                          positions=B * S)
    log(f"[lm] smokes on the card == the port's CPU run within "
        f"{LM_SMOKE_ULPS} bf16 ulps of the largest logit (forward, prefill, "
        f"decode; at positions routed alike, of all) and 2^-8 of the loss: "
        + ", ".join(f"{n} {max(r['max_abs_err'].values()):.2e} "
                    f"({r['positions_compared']}/{r['positions']})"
                    for n, r in rows.items())
        + f"; B6 launches a forward "
        f"{ {n: r['b6_launches'] for n, r in rows.items() if r['b6_launches']} }")
    return rows


def lm_b6_row(x, idx):
    """B6 at the prefill's dispatch shape (its first layer's tokens and
    words): timed beside its plain version and ``index_select`` on x with a
    zero row appended; the bound is bytes."""
    import torch

    from repro_torch.kernels import moe_gather as mg

    t, d = x.shape
    s = idx.shape[0]
    got = mg.moe_gather_cuda(x, idx)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    idx_pad = torch.where(idx < 0, t, idx)

    def library():
        return torch.index_select(x_pad, 0, idx_pad)

    check(torch.equal(got, mg.moe_gather_plain(x, idx))
          and torch.equal(got, library()),
          "lm: B6 at the prefill shape differs from plain / index_select")
    esize = x.element_size()
    used = int(torch.unique(idx[idx >= 0]).numel())
    nbytes = used * d * esize + s * d * esize + s * 4
    b_ms, b_by = bound(nbytes, 0, FP32_FLOP_PER_S)
    row = dict(T=t, d=d, S=s, dtype=str(x.dtype).split(".")[-1],
               live_slots=int((idx >= 0).sum()), tokens_read=used,
               bytes=nbytes, max_abs_err=0.0,
               ms=time_ms(lambda: mg.moe_gather_cuda(x, idx)),
               device_ms=device_ms(lambda: mg.moe_gather_cuda(x, idx),
                                   KERNEL_NAMES["moe_gather"]),
               plain_ms=time_ms(lambda: mg.moe_gather_plain(x, idx)),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
    log(f"[lm] B6 at the prefill dispatch (T={t}, d={d}, S={s}, "
        f"{row['dtype']}, {row['live_slots']} live slots): ms "
        f"{row['ms']:.4f} (device {row['device_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f}, index_select {row['library_ms']:.4f}, bound "
        f"{b_ms:.5f} ({b_by}, {nbytes} bytes) | bit-exact")
    return row


RESILIENT_EVERY = 2          # run_resilient's ckpt_every
RESILIENT_FAIL = 3           # the step whose first try is made to fail
RESILIENT_STEPS = 4          # max_steps
CKPT_DIR = ROOT / "build" / "resilient-ckpt"   # in the checkout, removed after


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def lm_resilient(full, device):
    """[resilient]: ``runtime.run_resilient`` over the LM train step at
    Qwen1.5-MoE-A2.7B's width, depth cut to LM_TRAIN_LAYERS, 8 x 512
    tokens from TokenStream, microbatches 4: a checkpoint every 2 steps,
    the first try of step 3 fails (an injected RuntimeError), the loop
    restores step 2 and runs to step 4. Times each step execution (saves
    excluded), each checkpoint's device-to-host snapshot and its write, the
    restore; B6 launches a step execution. Then [placement]'s checkpoint
    check: the step-4 checkpoint restored to the host and placed on the
    card by ``reshard_on_load`` over the host mesh's shardings == the final
    state, bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.runtime import fault_tolerance as ft
    from repro_torch.sharding.resolver import Resolver
    from repro_torch.training import train_loop as TTL
    from repro_torch.training.optimizer import _leaves

    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    params, axes = TM.init_model(gen, cfg, device=device)
    box = [TTL.init_state(params)]
    del params
    stream = TokenStream(cfg.vocab, LM_TRAIN[1], LM_TRAIN[0], seed=SEED + 2,
                         corpus_tokens=LM_CORPUS, device=device)
    step = TTL.make_train_step(cfg, warmup=0)
    execs, snaps, writes, restores = [], [], [], []

    def timed_step(state, batch):
        n = int(state.step)
        ops.reset_launch_counts()
        out, ms = _sync_ms(lambda: step(state, batch))
        execs.append(dict(step=n, ms=ms,
                          b6=ops.launch_counts["moe_gather"]))
        return out

    orig_save, orig_snap, orig_restore = (ck.save, ck.AsyncCheckpointer.save,
                                          ft.restore)

    def timed_write(root, n, tree, **kw):
        t0 = time.perf_counter()
        out = orig_save(root, n, tree, **kw)
        writes.append(dict(step=n, s=time.perf_counter() - t0,
                           bytes=_dir_bytes(out)))
        return out

    def timed_snapshot(self, n, tree):
        t0 = time.perf_counter()
        orig_snap(self, n, tree)
        snaps.append(dict(step=n, s=time.perf_counter() - t0))

    def timed_restore(root, template, **kw):
        held = torch.cuda.memory_allocated()   # the failed state is dropped
        t0 = time.perf_counter()
        out = orig_restore(root, template, **kw)
        torch.cuda.synchronize()
        restores.append(dict(step=out[1], s=time.perf_counter() - t0,
                             allocated_before_gib=held / 2**30))
        return out

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ck.save, ck.AsyncCheckpointer.save, ft.restore = (
        timed_write, timed_snapshot, timed_restore)
    t0 = time.perf_counter()
    try:
        state, history = ft.run_resilient(
            train_step=timed_step, state=box.pop(), batches=iter(stream),
            ckpt_root=str(CKPT_DIR), ckpt_every=RESILIENT_EVERY,
            fail_at={RESILIENT_FAIL: RuntimeError("injected")},
            max_steps=RESILIENT_STEPS)
        loop_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        final = int(state.step)
        # [placement]: the last checkpoint back through the host mesh
        mesh = make_host_mesh()
        sh = Resolver(mesh).tree_shardings(state, TTL.state_axes(axes))
        host = ck._tree_map(lambda t: None, state)
        restored, at = orig_restore(str(CKPT_DIR), host)
        t1 = time.perf_counter()
        placed = ck.reshard_on_load(restored, sh)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t1
        del restored
        same = all(p.device == mesh.devices[0, 0] and torch.equal(p, t)
                   for p, t in zip(_leaves(placed), _leaves(state)))
        del placed
    finally:
        ck.save, ck.AsyncCheckpointer.save, ft.restore = (
            orig_save, orig_snap, orig_restore)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ran = [e["step"] for e in execs]
    want_runs = [0, 1, 2, 2, 3]     # 3 fails before its step, 2 reruns
    check(final == RESILIENT_STEPS and ran == want_runs
          and [r["step"] for r in restores] == [2]
          and len(history) == len(want_runs)
          and np.isfinite(history).all(),
          f"resilient: final step {final}, step executions {ran}, restores "
          f"{restores}, history {history}")
    want = cfg.microbatches * LM_TRAIN_LAYERS * 2
    check(all(e["b6"] == want for e in execs),
          f"resilient: B6 launches a step execution "
          f"{[e['b6'] for e in execs]}, expected {want}")
    check(at == RESILIENT_STEPS and same,
          f"placement: reshard_on_load of the step-{at} checkpoint != the "
          "final state")
    ms = [e["ms"] for e in execs]
    out = dict(layers=cfg.n_layers, step_executions=execs, history=history,
               final_step=final, restores=restores, snapshots=snaps,
               writes=writes, loop_s=loop_s, peak_bytes=peak,
               ckpt_bytes=writes[0]["bytes"], placed_equal=same,
               place_s=place_s)
    log(f"[resilient] run_resilient over {cfg.name}'s train step at full "
        f"width, {cfg.n_layers} layers, {LM_TRAIN[0]}x{LM_TRAIN[1]} tokens, "
        f"microbatches {cfg.microbatches}: ckpt_every {RESILIENT_EVERY}, "
        f"step {RESILIENT_FAIL} fails (injected RuntimeError), max_steps "
        f"{RESILIENT_STEPS}: step executions {ran}, restored from "
        f"{[r['step'] for r in restores]}, final step {final}; history "
        f"{[round(x, 4) for x in history]}; loop {loop_s:.1f} s")
    log(f"[resilient]   a checkpoint {writes[0]['bytes'] / 1e9:.2f} GB "
        f"({[w['step'] for w in writes]}); snapshot to host s "
        f"{[round(x['s'], 2) for x in snaps]}, write s (background) "
        f"{[round(w['s'], 2) for w in writes]}, restore s "
        f"{[round(r['s'], 2) for r in restores]} (allocated before "
        f"{[round(r['allocated_before_gib'], 2) for r in restores]} GiB); ms a "
        f"step execution (saves excluded) {fmt_spread(spread(ms), '{:.1f}')};"
        f" peak {peak / 2**30:.2f} GiB; B6 launches a step execution "
        f"{[e['b6'] for e in execs]} (expected {want})")
    log(f"[placement] host mesh {mesh.shape} on {mesh.devices[0, 0]}: the "
        f"step-{at} checkpoint restored to the host and placed by "
        f"reshard_on_load over tree_shardings == the final state, bit for "
        f"bit ({len(_leaves(state))} leaves, {place_s:.2f} s)")
    del state
    return out


def lm_placement(full, smokes, device):
    """[placement]: ``tree_shardings`` of Qwen1.5-MoE-A2.7B's params (24
    layers, shapes on ``meta``) on the host mesh, every entry None or a
    size-1 axis; the MoE smoke's forward on the card under
    ``use_resolver`` == without, bit for bit, with the same B6 launches and
    the CPU run's constrain calls."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.sharding.resolver import Resolver, use_resolver
    from repro_torch.training.optimizer import _leaves, _map

    mesh = make_host_mesh()
    check(mesh.devices[0, 0] == torch.device("cuda", 0),
          f"placement: the host mesh is on {mesh.devices[0, 0]}")
    r = Resolver(mesh)
    meta, axes = TM.init_model(None, full, device="meta")
    specs = [s.spec for s in _leaves(r.tree_shardings(meta, axes))]
    check(all(all(mesh.shape[a] == 1 for e in sp if e is not None
                  for a in ((e,) if isinstance(e, str) else e))
              for sp in specs),
          "placement: a spec names an axis of size > 1 on the 1x1 mesh")
    cfg = smokes["moe"]
    params, _ = TM.init_model(torch.Generator().manual_seed(SEED), cfg,
                              device="cpu")
    batch = {k: v for k, v in _smoke_batch(cfg).items() if k != "labels"}
    cpu_r = Resolver(mesh)
    with torch.no_grad(), use_resolver(cpu_r):
        TM.forward(params, cfg, batch, remat=False)
    p = _map(lambda t: t.to(device), params)
    b = {k: v.to(device) for k, v in batch.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            ops.reset_launch_counts()
            plain, _ = TM.forward(p, cfg, b, remat=False)
            n_plain = ops.launch_counts["moe_gather"]
            ops.reset_launch_counts()
            with use_resolver(r):
                held, _ = TM.forward(p, cfg, b, remat=False)
            n_held = ops.launch_counts["moe_gather"]
    finally:
        torch.use_deterministic_algorithms(False)
    check(torch.equal(plain, held) and n_plain == n_held == cfg.n_layers
          and r.constraints == cpu_r.constraints
          and len(r.constraints) == 2 + 2 * cfg.n_layers,
          f"placement: the MoE smoke under use_resolver: equal "
          f"{torch.equal(plain, held)}, B6 {n_plain} / {n_held}, "
          f"{len(r.constraints)} constrain calls")
    out = dict(specs=len(specs), b6_launches=n_held,
               constrain_calls=len(r.constraints),
               sites=sorted({c[1] for c in r.constraints}))
    log(f"[placement] tree_shardings of {full.name}'s {len(specs)} parameter "
        f"leaves on the 1x1 host mesh: every entry None or a size-1 axis; "
        f"the moe smoke's forward on the card under use_resolver == without "
        f"bit for bit, B6 {n_plain} / {n_held} launches, "
        f"{len(r.constraints)} constrain calls (2 a forward + 2 a period "
        f"x {cfg.n_layers}) == the CPU run's")
    return out


def lm_dryrun(full, serve, train):
    """[dryrun] (host only): ``launch.dryrun.build_cell`` records of
    Qwen1.5-MoE-A2.7B's dimensions at train_4k, prefill_32k and decode_32k
    on the 16 x 16 virtual mesh, and train_4k under ``dp_only``; then, on a
    1 x 1 mesh, the roofline of this run's measured LM work (the serve
    phase's prefill and decode step, the 2-layer train step) on the H100
    constants, beside the measured times: the share of its roofline each
    reaches."""
    import dataclasses

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.resolver import Resolver

    cells = {}
    for shape, kw in (("train_4k", {}), ("prefill_32k", {}),
                      ("decode_32k", {}), ("train_4k", {"profile": "dp_only"})):
        key = shape + ("/dp_only" if kw else "")
        t0 = time.perf_counter()
        rec = DR.build_cell(full.name, shape, cfg=full, multi_pod=False, **kw)
        rec["build_s"] = time.perf_counter() - t0
        cells[key] = rec
        t, pd = rec["roofline_terms_s"], rec["per_device"]
        log(f"[dryrun] {full.name} {key} on {rec['mesh']} ({rec['n_chips']} "
            f"chips): per device {pd['traced_flops'] / 1e12:.3f} TFLOP, "
            f"{pd['traced_bytes'] / 1e9:.2f} GB traced, collectives "
            f"{pd['collective_bytes'] / 1e9:.3f} GB (analytic); terms s "
            f"compute {t['compute_s']:.4f}, memory {t['memory_s']:.4f}, "
            f"collective {t['collective_s']:.4f} -> {rec['bottleneck']}; "
            f"useful flops {rec['useful_flops_ratio']:.3f}; args "
            f"{rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} GB "
            f"a device; {rec['constrain_calls']} constrain calls; "
            f"{rec['traced_ops']} ops traced in {rec['build_s']:.1f} s")
    one = Resolver(make_production_mesh(dp=1, tp=1))
    B, S = LM_PROMPT
    train_cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    works = (("prefill", full, B, S, serve["prefill_ms"]),
             ("decode", full, B, S + LM_DECODE + 1,
              serve["decode_ms_per_step"]),
             ("train", train_cfg, LM_TRAIN[0], LM_TRAIN[1],
              spread(train["step_ms"][1:])["median"]))
    shares = {}
    for kind, cfg, b, seq, ms in works:
        tr = DR.trace_step(cfg, kind, batch=b, seq=seq, resolver=one)
        terms = DR.roofline(tr["flops"], tr["bytes"], 0.0)
        bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
        shares[kind] = dict(batch=b, seq=seq, layers=cfg.n_layers,
                            flops=tr["flops"], bytes=tr["bytes"],
                            ops=tr["ops"], compute_ms=terms["compute_s"] * 1e3,
                            memory_ms=terms["memory_s"] * 1e3,
                            roofline_ms=bound_ms, measured_ms=ms,
                            share=bound_ms / ms)
        log(f"[dryrun] 1x1 roofline of this run's {kind} ({cfg.n_layers} "
            f"layers, {b} x {seq}): {tr['flops'] / 1e12:.3f} TFLOP, "
            f"{tr['bytes'] / 1e9:.2f} GB over {tr['ops']} ops -> compute "
            f"{terms['compute_s'] * 1e3:.2f} ms, memory "
            f"{terms['memory_s'] * 1e3:.2f} ms; measured {ms:.1f} ms: "
            f"{bound_ms / ms:.3f} of its roofline")
    return dict(cells=cells, shares=shares)


def phase_lm(device):
    """[lm]: serve Qwen1.5-MoE-A2.7B's dimensions at full width and depth,
    train them at full width and two layers, run the nine smoke
    configurations; B6 on the MoE dispatch path."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full, smokes = lm_configs()
    serve, (b6_x, b6_idx) = lm_serve(full, device)
    gc.collect()
    torch.cuda.empty_cache()
    b6 = lm_b6_row(b6_x, b6_idx)
    b6["launches"] = serve["b6_prefill_launches"]
    del b6_x, b6_idx
    gc.collect()
    torch.cuda.empty_cache()
    train = lm_train(full, device)
    gc.collect()
    torch.cuda.empty_cache()
    smoke = lm_smokes(smokes, device)
    seconds = time.perf_counter() - t0
    log(f"[lm] phase {seconds:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    resilient = lm_resilient(full, device)
    resilient["phase_s"] = time.perf_counter() - t1
    log(f"[resilient] phase {resilient['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    placement = lm_placement(full, smokes, device)
    placement["phase_s"] = time.perf_counter() - t1
    log(f"[placement] phase {placement['phase_s']:.1f} s")
    t1 = time.perf_counter()
    dry = lm_dryrun(full, serve, train)
    dry["phase_s"] = time.perf_counter() - t1
    log(f"[dryrun] phase {dry['phase_s']:.1f} s")
    return dict(serve=serve, train=train, smokes=smoke, b6=b6,
                seconds=seconds, resilient=resilient, placement=placement,
                dryrun=dry)


def save_fleet_registry(params, device):
    """The fleet phase's two-handle registry, saved to its directory
    (for the parallel phase run alone)."""
    from repro_torch.core import engine
    from repro_torch.serve import ModelRegistry, save_registry

    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    ck_dir = FLEET_DIR / "registry"
    shutil.rmtree(ck_dir, ignore_errors=True)
    reg = ModelRegistry(device=device)
    for name, bits in (("cifar10-fp32", None), ("cifar10-w8", 8)):
        reg.register(name, params, th, cfg._replace(weight_bits=bits))
        reg.get(name).warmup(BUCKETS)
    save_registry(reg, str(ck_dir))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 chip_smoke.py")
    ap.add_argument("--only", choices=("parallel", "lm", "kernels"),
                    default=None,
                    help="run the device and build phases, then the "
                         "parallel, the lm or the kernels phase alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.snn_model import init_params
    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.device import resolve_device

    t_all = time.perf_counter()
    device = resolve_device("cuda")
    kind, smi_line = phase_device()
    build = phase_build()
    if args.only == "lm":
        lm = phase_lm(device)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_lm.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi_line, build=build, lm=lm,
            seconds=time.perf_counter() - t_all), indent=1))
        log(f"[done] {time.perf_counter() - t_all:.1f} s")
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    audit = None if args.only else phase_audit()
    lm = None if args.only else phase_lm(device)

    params = init_params(torch.Generator().manual_seed(SEED), SPEC, HW, C_IN,
                         device=device)
    if args.only == "parallel":
        save_fleet_registry(params, device)
        t_par = time.perf_counter()
        sharded = phase_parallel(params, device, kind)
        sharded["phase_s"] = time.perf_counter() - t_par
        log(f"[parallel] phase {sharded['phase_s']:.1f} s")
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_parallel.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi_line, build=build, parallel=sharded,
            seconds=time.perf_counter() - t_all), indent=1))
        log(f"[done] {time.perf_counter() - t_all:.1f} s")
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    th = tuple(torch.ones((), device=device) for _ in params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    imgs = torch.as_tensor(make_cifar_like(64, seed=SEED + 3)[0],
                           device=device)
    stages, last_raster = stage_inputs(params, th, cfg, imgs)
    b1, b1_err, b2, b2_err = phase_kernels(stages, last_raster, params,
                                           device)
    b3, b3_err = phase_b3(stages, device)
    c3 = phase_c3(device)
    if args.only == "kernels":
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi_line, build=build, b1=b1,
            b1_max_abs_err=b1_err, b2=b2, b2_max_abs_err=b2_err, b3=b3,
            b3_max_abs_err=b3_err, c3=c3,
            seconds=time.perf_counter() - t_all), indent=1))
        log(f"[done] {time.perf_counter() - t_all:.1f} s")
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    serve, launches, mask = phase_serve(params, device, kind)
    sparse = phase_sparse(params, th, cfg, imgs, device, kind)
    b5, b4, b4_err = phase_word_kernels(stages, device)
    b6, b6_launches = phase_moe(device)
    word = phase_word(params, th, cfg, imgs, device, kind)
    profile = phase_profile(params, th, cfg, imgs, kind)
    from repro_torch.study import StudyCache

    cache = StudyCache()       # the study and direct phases share it
    t_study = time.perf_counter()
    study = phase_study(kind, cache)
    study["phase_s"] = time.perf_counter() - t_study
    log(f"[study] phase {study['phase_s']:.1f} s")
    t_direct = time.perf_counter()
    direct = phase_direct(kind, cache, study["snn_acc"])
    direct["phase_s"] = time.perf_counter() - t_direct
    log(f"[direct] phase {direct['phase_s']:.1f} s")
    t_obs = time.perf_counter()
    traced = phase_obs(params, device, kind)
    traced["phase_s"] = time.perf_counter() - t_obs
    log(f"[obs] phase {traced['phase_s']:.1f} s")
    t_fleet = time.perf_counter()
    replicas = phase_fleet(params, device, kind)
    replicas["phase_s"] = time.perf_counter() - t_fleet
    log(f"[fleet] phase {replicas['phase_s']:.1f} s; the cache dir holds "
        f"{replicas['cache_dir_bytes']} bytes")
    t_par = time.perf_counter()
    sharded = phase_parallel(params, device, kind)
    sharded["phase_s"] = time.perf_counter() - t_par
    log(f"[parallel] phase {sharded['phase_s']:.1f} s")
    t_sweep = time.perf_counter()
    grid = phase_sweep(kind)
    grid["phase_s"] = time.perf_counter() - t_sweep
    log(f"[sweep] phase {grid['phase_s']:.1f} s")

    # per-kernel summary at the serve shapes: one bucket-64 execution,
    # i.e. B1 and B3 over the six event-driven stages at depth 64, B2 at
    # M=64; launches from each path's own counting window
    def path(rows):
        return [r for r in rows if r["depth"] == DEPTH
                and not r["stage"].startswith("conv0")]

    def analog_path(rows):
        return [r for r in rows if not r["stage"].startswith("conv0")]

    b1_path, b3_path = path(b1), path(b3)
    b4_path, b5_path = analog_path(b4), analog_path(b5)
    b4_bound, b4_by = bound(sum(r["bytes"] for r in b4_path),
                            sum(r["adds"] for r in b4_path), FP32_FLOP_PER_S)
    b5_bound, b5_by = bound(sum(r["bytes"] for r in b5_path),
                            sum(r["R"] * r["P"] for r in b5_path),
                            INT32_OP_PER_S)
    b6_main = lm["b6"]    # the prefill's dispatch (kernel_bench's: b6[0])
    b1_bound, b1_by = bound(sum(r["bytes"] for r in b1_path),
                            sum(r["adds"] for r in b1_path), FP32_FLOP_PER_S)
    b3_bound, b3_by = bound(sum(r["bytes"] for r in b3_path),
                            sum(r["adds"] for r in b3_path), FP32_FLOP_PER_S)
    b2_64 = [r for r in b2 if r["M"] == 64][0]
    kernels = [
        dict(name="fused_spike_accum", route="cuda",
             source="src/repro_torch/csrc/spike_pipeline.cu",
             replaces="src/repro/kernels/spike_pipeline.py:199",
             launches=launches["fused_spike_accum"], max_abs_err=b1_err,
             ms=sum(r["ms"] for r in b1_path),
             plain_ms=sum(r["plain_ms"] for r in b1_path),
             bound_ms=b1_bound, bound_by=b1_by,
             library_ms=sum(r["library_ms"] for r in b1_path)),
        dict(name="quant_matmul", route="cuda",
             source="src/repro_torch/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:37",
             launches=launches["quant_matmul"], max_abs_err=b2_err,
             ms=b2_64["ms"], plain_ms=b2_64["plain_ms"],
             bound_ms=b2_64["bound_ms"], bound_by=b2_64["bound_by"],
             library_ms=b2_64["library_ms"]),
        dict(name="fused_spike_accum_sparse", route="cuda",
             source="src/repro_torch/csrc/spike_sparse.cu",
             replaces="src/repro/kernels/spike_sparse.py:330",
             launches=sparse["launches"]["fused_spike_accum_sparse"],
             max_abs_err=b3_err, ms=sum(r["ms"] for r in b3_path),
             plain_ms=sum(r["plain_ms"] for r in b3_path),
             bound_ms=b3_bound, bound_by=b3_by,
             library_ms=sum(r["library_ms"] for r in b3_path)),
        dict(name="event_accum", route="cuda",
             source="src/repro_torch/csrc/event_accum.cu",
             replaces="src/repro/kernels/event_accum.py:99",
             launches=word["launches"]["event_accum"], max_abs_err=b4_err,
             ms=sum(r["ms"] for r in b4_path),
             plain_ms=sum(r["plain_ms"] for r in b4_path),
             bound_ms=b4_bound, bound_by=b4_by,
             library_ms=sum(r["library_ms"] for r in b4_path)),
        dict(name="spike_compact", route="cuda",
             source="src/repro_torch/csrc/spike_compact.cu",
             replaces="src/repro/kernels/spike_compact.py:42",
             launches=word["launches"]["spike_compact"], max_abs_err=0.0,
             ms=sum(r["ms"] for r in b5_path),
             plain_ms=sum(r["plain_ms"] for r in b5_path),
             bound_ms=b5_bound, bound_by=b5_by, library_ms=None),
        dict(name="moe_gather", route="cuda",
             source="src/repro_torch/csrc/moe_gather.cu",
             replaces="src/repro/kernels/moe_gather.py:33",
             launches=b6_main["launches"], max_abs_err=0.0, ms=b6_main["ms"],
             plain_ms=b6_main["plain_ms"], bound_ms=b6_main["bound_ms"],
             bound_by=b6_main["bound_by"], library_ms=b6_main["library_ms"]),
    ]
    windows = ("serve (graph replays)", "serve (graph replays)",
               "queue_sparse", "queue", "queue", "lm prefill")
    for k, window in zip(kernels, windows):
        lib = ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.4f}")
        unit = ("per call at the lm prefill's dispatch shape"
                if k["name"] == "moe_gather" else "per bucket-64 execution")
        log(f"[summary] {k['name']}: {k['ms']:.4f} ms {unit} "
            f"(plain {k['plain_ms']:.4f}, library {lib}, bound "
            f"{k['bound_ms']:.6f} {k['bound_by']}), {k['launches']} launches "
            f"in the {window} window")
    details = dict(device=kind, nvidia_smi=smi_line, build=build,
                   b1=b1, b2=b2, b3=b3, c3=c3, b4=b4, b5=b5, b6=b6,
                   b6_kernel_bench_launches=b6_launches, lm=lm,
                   serve=serve,
                   mask_contract=mask, sparse=sparse, word=word,
                   kernels=kernels, profile=profile, study=study,
                   direct=direct, obs=traced, fleet=replicas,
                   parallel=sharded, sweep=grid, audit=audit,
                   seconds=time.perf_counter() - t_all)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
