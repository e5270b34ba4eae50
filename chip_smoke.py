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
   at M in {1, 4, 16, 64}, K=1152, N=10, bit-exactly; the sparse kernel
   (B3) on the same occupancy at depth 64: fp32 on dyadic weights bit-exact
   and on Gaussian weights to 1e-4 against its plain version (and
   bit-exact against B1, whose order of adds it keeps), ``weight_bits=8``
   bit-exact, and a ragged case (1/8 of the rows active, ``n_rows`` < N)
   bit-exact and timed beside B1. Each is timed with CUDA events beside its
   plain version, a library call and its bound.
4. serve   — the full-width CIFAR-10 net (paper Table 6) behind the port's
   ModelRegistry + ServeRuntime on ``queue_pallas``, one fp32 handle and
   one ``weight_bits=8`` handle, loaded as the reference's
   ``serve/bench.py`` ``closed_loop`` loads it: all 256 requests (its
   default) submitted, then the queue drained; repeated ``SERVE_RUNS``
   times per handle. Launch counters are zeroed just before and read just
   after; B1 must launch 6 times per executed bucket and B2 once per bucket
   of the w8 handle. Per-request energies must sum to a one-shot
   ``price_record``; padded == unpadded is checked per bucket with a
   partly filled bucket (bit-exact required on every handle, the Gaussian
   fp32 one included: the fp32 head multiplies fixed-shape tiles); kernel
   results must equal the port's CPU run (plain versions) on a small dyadic
   input.
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
6. profile — bucket-64 executions per serving handle, in
   ``PROFILE_WINDOWS`` windows: each window's wall time and device time by
   kernel (torch.profiler) come from the same calls, so the device's idle
   share is read within one window; the spread across windows is printed.

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
# int32 outside the tensor cores: half the fp32 rate, as an H100 SM has 64
# INT32 lanes to 128 FP32 ones (NVIDIA H100 Tensor Core GPU Architecture
# white paper); counted like the fp32 peak, a multiply-add as two ops
INT32_OP_PER_S = FP32_FLOP_PER_S / 2

# kernel -> substrings of its CUDA kernels' names in a profiler trace
KERNEL_NAMES = {
    "fused_spike_accum": ("fused_spike_accum_kernel",),
    "quant_matmul": ("quant_matmul_kernel",),
    "fused_spike_accum_sparse": ("sparse_gate_kernel", "sparse_rows_kernel",
                                 "sparse_accum_kernel"),
}


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
                return sp.fused_spike_accum_cuda(occ, w, bits=fmt.bits_coord,
                                                 **kw)

            def plain(w=w_gauss, kw=kw):
                return sp.fused_spike_accum_plain(occ, w, **kw)

            def library(w=w_gauss, depth=depth):
                return dropped_conv(occ, cp, w, depth)

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
            events, adds, nbytes = stage_work(occ, cp, depth, w_gauss, device)
            b_ms, b_by = bound(nbytes, adds, FP32_FLOP_PER_S)
            row = dict(stage=name, N=occ.shape[0], C_in=cp.in_c, hw=cp.in_hw,
                       C_out=cp.out_c, P=P, depth=depth,
                       events=events, adds=adds, bytes=nbytes,
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
        library_ms = time_ms(library)
        library_note = (f"torch._int_mm on A {tuple(a_pad.shape)} x W "
                        f"{tuple(w_q_pad.shape)} zero-padded, sliced to "
                        f"({M}, {N}), same dequant")
        nbytes = M * Kd + Kd * N + M * N * 4 + 8
        b_ms, b_by = bound(nbytes, 2 * M * Kd * N, INT8_OP_PER_S)
        row = dict(M=M, K=Kd, N=N, ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=library_ms, library_note=library_note,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=b2_err)
        b2_rows.append(row)
        log(f"[kernels] B2 M={M:3d} K={Kd} N={N} | ms {row['ms']:.4f} "
            f"plain {row['plain_ms']:.4f} library {library_ms:.4f} "
            f"({library_note}) bound {b_ms:.6f} ({b_by}) | bit-exact")
    return b1_rows, b1_err, b2_rows, b2_err


def phase_b3(stages, device):
    """B3 against its plain version at the serve shapes (N = 64*4 rows,
    depth 64, the Gaussian net's real occupancy), fp32 and weight_bits=8,
    plus a ragged case; timed beside B1, the plain version and cuDNN."""
    import torch

    from repro_torch.core.quantization import quantize_symmetric
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
                o, w, bits=fmt.bits_coord, weight_bits=wb, n_rows=n_rows,
                **kw)

        def plain(w=w_gauss, wb=None, o=occ, e_cap=e_cap):
            return ss.fused_spike_accum_sparse_plain(
                o, w, e_cap=e_cap, weight_bits=wb, **kw)

        def b1(w=w_gauss, o=occ):
            return sp.fused_spike_accum_cuda(o, w, bits=fmt.bits_coord, **kw)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
              f"B3 {name}: Gaussian max |err| {err} vs the plain version")
        check(torch.equal(got, b1()),
              f"B3 {name}: Gaussian weights differ from B1 (max |err| "
              f"{float((got - b1()).abs().max())})")
        got_dy, want_dy = kernel(w_dy), plain(w_dy)
        check(torch.equal(got_dy, want_dy),
              f"B3 {name}: dyadic weights not bit-exact (max |err| "
              f"{float((got_dy - want_dy).abs().max())})")
        got_q, want_q = kernel(wb=8), plain(wb=8)
        check(torch.equal(got_q, want_q),
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

        w_q, w_scale = quantize_symmetric(w_gauss, 8)
        w_int = w_q.float()

        def library_q(w=w_int, scale=w_scale):
            return dropped_conv(occ, cp, w, DEPTH) * scale

        events, adds, nbytes = stage_work(occ, cp, DEPTH, w_gauss, device)
        ev_r, adds_r, bytes_r = stage_work(occ_r, cp, DEPTH, w_gauss, device)
        b_ms, b_by = bound(nbytes, adds, FP32_FLOP_PER_S)
        bq_ms, bq_by = bound(nbytes, adds, INT32_OP_PER_S)
        br_ms, br_by = bound(bytes_r, adds_r, FP32_FLOP_PER_S)
        row = dict(
            stage=name, N=N, C_in=cp.in_c, hw=cp.in_hw, C_out=cp.out_c,
            depth=DEPTH, events=events, adds=adds, bytes=nbytes, e_cap=e_cap,
            max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
            library_ms=time_ms(lambda: dropped_conv(occ, cp, w_gauss, DEPTH)),
            b1_ms=time_ms(b1), bound_ms=b_ms, bound_by=b_by,
            w8_ms=time_ms(lambda: kernel(wb=8)),
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
            f"(B1 {row['b1_ms']:.4f}) plain {row['plain_ms']:.4f} library "
            f"{row['library_ms']:.4f} bound {b_ms:.4f} ({b_by}) | w8 ms "
            f"{row['w8_ms']:.4f} plain {row['w8_plain_ms']:.4f} library "
            f"{row['w8_library_ms']:.4f} bound {bq_ms:.4f} ({bq_by}) | "
            f"ragged {n_act}/{N} rows ms {row['ragged_ms']:.4f} (B1 "
            f"{row['ragged_b1_ms']:.4f}) | max|err| {err:.3g}, == B1, "
            "dyadic/w8/ragged bit-exact")
    return rows, err_max


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

    # mask contract, per bucket: every handle held bit-exact
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
            check(same, f"mask contract broken on {name} bucket {b}: "
                  f"max |logit diff| {diff}")
    log(f"[serve] padded == unpadded: {len(mask)}/{len(mask)} (handle, "
        "bucket) pairs bit-exact")

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
    return dict(
        unprofiled_wall_ms=bare_ms, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
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


def phase_profile(params, ths, cfg, images, kind):
    """Where a bucket-64 execution's time goes, for an fp32 and a
    ``weight_bits=8`` serving handle, in ``PROFILE_WINDOWS`` windows of 5
    synchronized ``run_bucket`` calls each (:func:`profile_window`)."""
    from repro_torch.serve import ModelRegistry

    registry = ModelRegistry(device=images.device)
    handles = {n: registry.register(n, params, ths, c) for n, c in (
        ("cifar10-fp32", cfg), ("cifar10-w8", cfg._replace(weight_bits=8)))}
    images = images.cpu().numpy()
    B, out = images.shape[0], {}
    for name, h in handles.items():
        h.run_bucket(images, B)                            # warm
        windows = [profile_window(lambda: h.run_bucket(images, B))
                   for _ in range(PROFILE_WINDOWS)]
        out[name] = dict(bucket=B, windows=windows,
                         **log_windows("profile", name, windows, kind))
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
    stages, last_raster = stage_inputs(params, th, cfg, imgs)
    b1, b1_err, b2, b2_err = phase_kernels(stages, last_raster, params,
                                           device)
    b3, b3_err = phase_b3(stages, device)
    serve, launches, mask = phase_serve(params, device, kind)
    sparse = phase_sparse(params, th, cfg, imgs, device, kind)
    profile = phase_profile(params, th, cfg, imgs, kind)

    # per-kernel summary at the serve shapes: one bucket-64 execution,
    # i.e. B1 and B3 over the six event-driven stages at depth 64, B2 at
    # M=64; launches from each path's own counting window
    def path(rows):
        return [r for r in rows if r["depth"] == DEPTH
                and not r["stage"].startswith("conv0")]

    b1_path, b3_path = path(b1), path(b3)
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
    ]
    windows = ("serve", "serve", "queue_sparse")
    for k, window in zip(kernels, windows):
        log(f"[summary] {k['name']}: {k['ms']:.4f} ms per bucket-64 "
            f"execution (plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']:.4f}, bound {k['bound_ms']:.6f} "
            f"{k['bound_by']}), {k['launches']} launches in the {window} "
            "window")
    details = dict(device=kind, nvidia_smi=smi_line, build=build,
                   b1=b1, b2=b2, b3=b3, serve=serve, mask_contract=mask,
                   sparse=sparse, kernels=kernels, profile=profile,
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
