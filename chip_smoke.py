#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of the SNN serving path on one CUDA card.

    python3 chip_smoke.py

Phases (each one fails loudly; the script exits non-zero on any failure):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — compiles every kernel under ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel) into the git-ignored build dir.
3. kernels — at the CIFAR-10 serve shapes (bucket 64, T=4): the fused spike
   kernel (B1) on every conv stage's real occupancy, at depth 64 and 256,
   with the net's Gaussian weights (held to 1e-4) and dyadic weights (held
   bit-exactly) against its plain PyTorch version; the int8 head kernel (B2)
   at M in {1, 4, 16, 64}, K=1152, N=10, bit-exactly. Each is timed with
   CUDA events beside its plain version, a library call and its bound.
4. serve   — the full-width CIFAR-10 net (paper Table 6) behind the port's
   ModelRegistry + ServeRuntime on ``queue_pallas``, one fp32 handle and
   one ``weight_bits=8`` handle, loaded as the reference's
   ``serve/bench.py`` ``closed_loop`` loads it: all 256 requests (its
   default) submitted, then the queue drained; repeated ``SERVE_RUNS``
   times per handle. Launch counters are zeroed just before and read just
   after; B1 must launch 6 times per executed bucket and B2 once per bucket
   of the w8 handle. Per-request energies must sum to a one-shot
   ``price_record``; padded == unpadded is checked per bucket with a
   partly filled bucket (bit-exact required on a dyadic net, reported on
   the Gaussian one); kernel results must equal the port's CPU run (plain
   versions) on a small dyadic input.
5. profile — bucket-64 executions per handle, in ``PROFILE_WINDOWS``
   windows: each window's wall time and device time by kernel
   (torch.profiler) come from the same calls, so the device's idle share
   is read within one window; the spread across windows is printed.

Output: human-readable lines, then a JSON ``{"kernels": [...]}`` line, then
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Details
go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
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
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # non-tensor-core fp32
INT8_OP_PER_S = 1979e12        # int8 tensor cores


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
    log(f"[device] {kind} | nvidia-smi: {smi_line} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible")
    return kind, smi_line


def phase_build():
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    paths = _cuda.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        build_log = _cuda.BUILD / f"{name}.log"
        lines = build_log.read_text().splitlines() if build_log.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")
    return {n: str(p) for n, p in paths.items()}


def phase_kernels(params, ths, cfg, images, device):
    """B1 and B2 against their plain versions at the serve shapes, timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.aeq import segment_keep, span_map
    from repro_torch.core.quantization import quantize_symmetric
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_pipeline as sp

    gen = torch.Generator().manual_seed(SEED + 1)
    stages, last_raster = stage_inputs(params, ths, cfg, images)
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
                return sp.fused_spike_accum_cuda(occ, w, bits=fmt.bits_coord,
                                                 **kw)

            def plain(w=w_gauss, kw=kw):
                return sp.fused_spike_accum_plain(occ, w, **kw)

            def library(w=w_gauss, depth=depth):
                keep = segment_keep(occ, depth)
                m = keep.reshape(-1, cp.in_c, cp.kernel, cp.kernel, fmt.n_win,
                                 fmt.n_win).permute(0, 1, 4, 2, 5, 3)
                m = m.reshape(-1, cp.in_c, fmt.n_win * cp.kernel,
                              fmt.n_win * cp.kernel)[:, :, :cp.in_hw,
                                                     :cp.in_hw]
                return F.conv2d(m.float(), w.permute(3, 2, 0, 1),
                                padding=cp.kernel // 2)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
                  f"B1 {name} depth {depth}: Gaussian max |err| {err}")
            got_dy, want_dy = kernel(w_dy), plain(w_dy)
            oracle = ref.fused_spike_accum_ref(occ, w_dy, **kw)
            check(torch.equal(got_dy, oracle),
                  f"B1 {name} depth {depth}: dyadic weights differ from the "
                  "scatter oracle (max |err| "
                  f"{float((got_dy - oracle).abs().max())})")
            check(torch.equal(got_dy, want_dy),
                  f"B1 {name} depth {depth}: dyadic weights not bit-exact "
                  f"(max |err| {float((got_dy - want_dy).abs().max())})")
            b1_err = max(b1_err, err)
            keep = segment_keep(occ, depth)
            spans = span_map(fmt, cp.in_hw, device)
            adds = int((keep * spans).sum()) * cp.out_c
            nbytes = (occ.numel() * 4 + w_gauss.numel() * 4
                      + got.numel() * 4)
            b_ms, b_by = bound(nbytes, adds, FP32_FLOP_PER_S)
            row = dict(stage=name, N=occ.shape[0], C_in=cp.in_c, hw=cp.in_hw,
                       C_out=cp.out_c, P=P, depth=depth,
                       events=int(keep.sum()), adds=adds, bytes=nbytes,
                       max_abs_err=err, ms=time_ms(kernel),
                       plain_ms=time_ms(plain), library_ms=time_ms(library),
                       bound_ms=b_ms, bound_by=b_by)
            b1_rows.append(row)
            log(f"[kernels] B1 {name:21s} N={row['N']} C_in={cp.in_c} "
                f"hw={cp.in_hw} C_out={cp.out_c} depth={depth} "
                f"events={row['events']} adds={adds} | ms {row['ms']:.4f} "
                f"plain {row['plain_ms']:.4f} library {row['library_ms']:.4f}"
                f" bound {b_ms:.4f} ({b_by}) | max|err| {err:.3g}")

    # B2: the output head at every bucket, on real spike counts
    w_out = params[-1]["w"]
    w_q, w_scale = quantize_symmetric(w_out, 8)
    w_q = w_q.contiguous()
    one = torch.ones((), dtype=torch.float32, device=device)
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

        library_ms, library_note = None, ""
        try:
            torch._int_mm(counts, w_q)
        except RuntimeError as e:
            library_note = str(e).splitlines()[0][:120]
        else:
            library_ms = time_ms(
                lambda a=counts: torch._int_mm(a, w_q).float()
                * (one * w_scale))
        Kd, N = w_q.shape
        nbytes = M * Kd + Kd * N + M * N * 4 + 8
        b_ms, b_by = bound(nbytes, 2 * M * Kd * N, INT8_OP_PER_S)
        row = dict(M=M, K=Kd, N=N, ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=library_ms, library_note=library_note,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=b2_err)
        b2_rows.append(row)
        lib = (f"{library_ms:.4f}" if library_ms is not None
               else f"null ({library_note})")
        log(f"[kernels] B2 M={M:3d} K={Kd} N={N} | ms {row['ms']:.4f} "
            f"plain {row['plain_ms']:.4f} library {lib} bound {b_ms:.6f} "
            f"({b_by}) | bit-exact")
    return b1_rows, b1_err, b2_rows, b2_err


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


def phase_serve(params, device, kind):
    """Serve the full-width net through the port; check counters, energy
    metering and the mask contract."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_cifar_like
    from repro_torch.kernels import ops
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime
    from repro_torch.study import StatsRecord, price_record

    registry = ModelRegistry(capacity=4, device=device)
    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    handles = {
        "cifar10-fp32": registry.register("cifar10-fp32", params, th, cfg),
        "cifar10-w8": registry.register("cifar10-w8", params, th,
                                        cfg._replace(weight_bits=8)),
    }
    t0 = time.perf_counter()
    for h in handles.values():
        h.warmup(BUCKETS)
    torch.cuda.synchronize()
    log(f"[serve] warmup of {len(handles)} handles x buckets {BUCKETS}: "
        f"{time.perf_counter() - t0:.2f} s")

    images, _ = make_cifar_like(N_REQUESTS, seed=SEED + 7)
    runtime = ServeRuntime(registry, BucketPolicy(BUCKETS))
    results = {}

    ops.reset_launch_counts()                      # the main-path window
    for name in handles:
        for run in range(SERVE_RUNS):              # closed loop, as the
            batches0 = runtime.n_batches           # reference bench runs it
            step_s, responses = [], []
            t_start = time.perf_counter()
            for im in images:
                runtime.submit(im, name)
            while runtime.pending():
                t = time.perf_counter()
                responses.extend(runtime.step())
                step_s.append(time.perf_counter() - t)
            wall = time.perf_counter() - t_start
            results[(name, run)] = dict(
                responses=responses, steps=step_s, wall=wall,
                batches=runtime.n_batches - batches0)
    launches = dict(ops.launch_counts)             # read right after
    log(f"[serve] launches in the serve window: {launches}")

    n_batches = sum(r["batches"] for r in results.values())
    w8_batches = sum(r["batches"] for (name, _), r in results.items()
                     if name == "cifar10-w8")
    check(launches["fused_spike_accum"] == 6 * n_batches,
          f"B1 launched {launches['fused_spike_accum']} times for "
          f"{n_batches} buckets (expected 6 per bucket)")
    check(launches["quant_matmul"] == w8_batches,
          f"B2 launched {launches['quant_matmul']} times for "
          f"{w8_batches} w8 buckets (expected 1 each)")

    summary = {}
    for name in handles:
        runs = []
        for run in range(SERVE_RUNS):
            r = results[(name, run)]
            resp = sorted(r["responses"], key=lambda x: x.rid)
            check(len(resp) == N_REQUESTS, f"{name}: {len(resp)} responses")
            logits = np.stack([x.logits for x in resp])
            check(logits.shape == (N_REQUESTS, 10)
                  and np.isfinite(logits).all(),
                  f"{name}: logits not finite or of shape {logits.shape}")
            record = StatsRecord(*(np.concatenate([getattr(x.stats, f)
                                                   for x in resp])
                                   for f in StatsRecord._fields))
            one_shot = price_record(record, input_hw=HW).total_j.numpy()
            served = np.array([x.energy_j for x in resp], np.float32)
            check(np.array_equal(served, one_shot)
                  and served.sum() == one_shot.sum(),
                  f"{name}: per-request energies differ from one-shot "
                  "pricing")
            latency = np.array([x.latency_s for x in resp]) * 1e3
            hist = {}
            for x in resp:
                hist[x.bucket] = hist.get(x.bucket, 0) + 1
            runs.append(dict(
                batches=r["batches"], requests_per_s=N_REQUESTS / r["wall"],
                latency_ms_p50=float(np.percentile(latency, 50)),
                latency_ms_p99=float(np.percentile(latency, 99)),
                step_ms=[v * 1e3 for v in r["steps"]],
                requests_by_bucket=hist))
        s = dict(requests=N_REQUESTS, runs=runs,
                 requests_per_s=spread([x["requests_per_s"] for x in runs]),
                 latency_ms_p50=spread([x["latency_ms_p50"] for x in runs]),
                 latency_ms_p99=spread([x["latency_ms_p99"] for x in runs]),
                 step_ms=spread([v for x in runs for v in x["step_ms"]]),
                 events_per_layer=record.events_in.mean(0).tolist(),
                 spikes_per_layer=record.spikes_out.mean(0).tolist(),
                 adds_per_layer=record.add_ops.mean(0).tolist(),
                 overflow_per_request=float(record.overflow.mean()),
                 energy_j_sum=float(served.sum()),
                 preds=np.bincount([x.pred for x in resp],
                                   minlength=10).tolist())
        summary[name] = s
        log(f"[serve] {name} on {kind}, closed loop ({N_REQUESTS} requests "
            f"submitted, then drained; {SERVE_RUNS} runs; buckets "
            f"{runs[-1]['requests_by_bucket']}): req/s "
            f"{fmt_spread(s['requests_per_s'], '{:.1f}')} | request latency "
            f"p50 {fmt_spread(s['latency_ms_p50'])} ms, p99 "
            f"{fmt_spread(s['latency_ms_p99'])} ms | step "
            f"{fmt_spread(s['step_ms'])} ms | energy sum "
            f"{s['energy_j_sum']:.6g} J (pricing model) == one-shot "
            "price_record")
        log(f"[serve]   mean per request: events_in "
            f"{[round(v, 1) for v in s['events_per_layer']]} spikes_out "
            f"{[round(v, 1) for v in s['spikes_per_layer']]} overflow "
            f"{s['overflow_per_request']:.1f}")

    # mask contract, per bucket: Gaussian handles reported, dyadic exact
    dy = dyadic_params(params, device)
    dyh = {
        "dyadic-fp32": registry.register("dyadic-fp32", dy, th, cfg),
        "dyadic-w8": registry.register("dyadic-w8", dy, th,
                                       cfg._replace(weight_bits=8)),
    }
    mask_imgs, _ = make_cifar_like(max(BUCKETS), seed=SEED + 11)
    imgs_dy = np.round(mask_imgs * 256) / 256
    mask = {}
    for name, h in {**handles, **dyh}.items():
        src = imgs_dy if name.startswith("dyadic") else mask_imgs
        for b in BUCKETS:
            if b == 1:                 # a full bucket of one: nothing to mask
                continue
            n = b // 2 + 1             # rows n..b-1 are other images
            lp, sp_ = h.run_bucket(src[:b].astype(np.float32), n)
            lu, su = h.run_bucket(src[:n].astype(np.float32), n)
            same = torch.equal(lp, lu) and _stats_equal(sp_, su)
            diff = float((lp - lu).abs().max())
            mask[f"{name} B={b} n={n}"] = dict(
                bit_exact=same, max_abs_logit_diff=diff,
                stats_equal=_stats_equal(sp_, su))
            if name.startswith("dyadic"):
                check(same, f"mask contract broken on {name} bucket {b}: "
                      f"max |logit diff| {diff}")
    n_exact = sum(v["bit_exact"] for v in mask.values())
    log(f"[serve] padded == unpadded: {n_exact}/{len(mask)} bit-exact; "
        + "; ".join(f"{k}: {v['max_abs_logit_diff']:.3g}"
                    for k, v in mask.items() if not v["bit_exact"]))

    # the kernels against the port's CPU run (plain versions), small input
    agree = {}
    for name, h in dyh.items():
        small = imgs_dy[:3].astype(np.float32)
        lg, sg = engine.infer_batch(h.params, h.thresholds, h.cfg, small,
                                    device=device)
        lc, sc = engine.infer_batch([{k: v.cpu() for k, v in p.items()}
                                     for p in h.params],
                                    [t.cpu() for t in h.thresholds], h.cfg,
                                    small, device="cpu")
        same = torch.equal(lg.cpu(), lc) and _stats_equal(
            [s.cpu() for s in sg], sc)
        check(same, f"{name}: GPU kernels disagree with the CPU plain run "
              f"(max |logit diff| {float((lg.cpu() - lc).abs().max())})")
        agree[name] = same
    log(f"[serve] GPU == CPU plain run on 3 dyadic images: {agree}")
    return summary, launches, mask


def phase_profile(params, ths, cfg, images, kind):
    """Where a bucket-64 execution's time goes, for an fp32 and a
    ``weight_bits=8`` handle, in ``PROFILE_WINDOWS`` windows of 5
    synchronized ``run_bucket`` calls each. Within one window torch.profiler
    records the device time by kernel name and the host clock spans the
    same calls, so the idle share (1 - device busy / wall) is read within
    one window. One stream, so kernel times add up without overlap. The
    profiler's own host cost is in that wall; an unprofiled window of 5
    calls before each profiled one shows how large it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ModelRegistry

    registry = ModelRegistry(device=images.device)
    handles = {n: registry.register(n, params, ths, c) for n, c in (
        ("cifar10-fp32", cfg), ("cifar10-w8", cfg._replace(weight_bits=8)))}
    images = images.cpu().numpy()
    B, reps, out = images.shape[0], 5, {}
    for name, h in handles.items():
        h.run_bucket(images, B)                            # warm
        windows = []
        for _ in range(PROFILE_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(reps):
                h.run_bucket(images, B)
            bare_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    h.run_bucket(images, B)
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            rows = []  # device-side events only: the kernels and copies
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    rows.append((e.device_time_total / 1e3 / reps,
                                 e.count // reps, e.key))
            rows.sort(reverse=True)
            check(rows, f"{name}: the profiler saw no device time")
            busy_ms = sum(r[0] for r in rows)
            windows.append(dict(
                unprofiled_wall_ms=bare_ms, wall_ms=wall_ms,
                device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                device_ops=sum(r[1] for r in rows),
                port_kernels_device_ms={
                    k: sum(r[0] for r in rows if f"{k}_kernel" in r[2])
                    for k in ("fused_spike_accum", "quant_matmul")},
                top=[dict(ms=r[0], calls=r[1], name=r[2][:90])
                     for r in rows[:12]]))
        out[name] = dict(bucket=B, windows=windows, **{
            k: spread([w[k] for w in windows])
            for k in ("unprofiled_wall_ms", "wall_ms", "device_busy_ms",
                      "idle_share")})
        o = out[name]
        log(f"[profile] {name} bucket {B} on {kind}, {PROFILE_WINDOWS} "
            f"windows x {reps} calls, median (min, max): wall "
            f"{fmt_spread(o['wall_ms'])} ms, device busy "
            f"{fmt_spread(o['device_busy_ms'])} ms in "
            f"{windows[-1]['device_ops']} device ops, idle share "
            f"{fmt_spread(o['idle_share'])} | unprofiled wall "
            f"{fmt_spread(o['unprofiled_wall_ms'])} ms | device ms of the "
            f"port's kernels (last window): "
            f"{windows[-1]['port_kernels_device_ms']}")
        for r in windows[-1]["top"]:
            log(f"[profile]   {r['ms']:9.4f} ms  x{r['calls']:<4d} "
                f"{r['name']}")
    return out


def main() -> int:
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

    params = init_params(torch.Generator().manual_seed(SEED), SPEC, HW, C_IN,
                         device=device)
    th = tuple(torch.ones((), device=device) for _ in params)
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C_IN, T=T,
                           mode=MODE, depth=DEPTH)
    imgs = torch.as_tensor(make_cifar_like(64, seed=SEED + 3)[0],
                           device=device)
    b1, b1_err, b2, b2_err = phase_kernels(params, th, cfg, imgs, device)
    serve, launches, mask = phase_serve(params, device, kind)
    profile = phase_profile(params, th, cfg, imgs, kind)

    # per-kernel summary at the serve shapes: one bucket-64 execution,
    # i.e. B1 over the six event-driven stages at depth 64, B2 at M=64
    b1_path = [r for r in b1 if r["depth"] == DEPTH
               and not r["stage"].startswith("conv0")]
    b1_bound, b1_by = bound(sum(r["bytes"] for r in b1_path),
                            sum(r["adds"] for r in b1_path), FP32_FLOP_PER_S)
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
    ]
    for k in kernels:
        log(f"[summary] {k['name']}: {k['ms']:.4f} ms per bucket-64 "
            f"execution (plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']}, bound {k['bound_ms']:.6f} {k['bound_by']}),"
            f" {k['launches']} launches in the serve window")
    details = dict(device=kind, nvidia_smi=smi_line, build=build,
                   b1=b1, b2=b2, serve=serve, mask_contract=mask,
                   kernels=kernels, profile=profile,
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
