#!/usr/bin/env python3
"""Device times of the port's B1-B4 and B6 kernels from one tree, on one card.

    python3 scripts/time_kernels.py [--src PATH/src] [--tag NAME] [--out FILE]
                                    [--kernels b1,b2,b3,b4,b6]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds that tree's kernels and times them on the same inputs, so that one
call on the card can time two trees in turns (an earlier one unpacked with
``git archive`` into a git-ignored directory): earlier, this, this,
earlier. The inputs come from ``chip_smoke.py``'s helpers in this checkout,
at its seed: the full-width CIFAR-10 net at bucket 64, T=4, depth 64.

- B1 (``fused_spike_accum_cuda``) and B3 (``fused_spike_accum_sparse_cuda``,
  fp32 and ``weight_bits=8``): every analog stage's real occupancy at depth
  64 (64 * 4 rows); summed, one bucket-64 ``queue_pallas`` (B1) or
  ``queue_sparse`` (B3) execution's work (B1 with its queue statistics,
  ``steps`` = T, as ``queue_pallas`` runs it; its device time holds the
  memset that zeroes them);
- B2 (``quant_matmul_cuda``): the output head, M in {1, 4, 16, 64}, K=1152,
  N=10, and (256, 256, 256), beside ``torch._int_mm`` (A and B zero-padded
  to its smallest shape, then the same dequant);
- B4 (``event_accum_cuda``): every analog stage's real queues (B5 on the
  stage's occupancy), the 4 steps of 64 rows each; summed, this is one
  bucket-64 ``queue`` execution's B4 work;
- B6 (``moe_gather_cuda``): kernel_bench's (T, d, S) = (1024, 128, 512) f32
  and (4096, 4096, 8192) bf16, beside ``index_select`` on x with a zero row
  appended.

Each time is the mean over 20 calls after 3 warm-ups: device ms from
torch.profiler (the kernel alone) and CUDA-event ms (with the host's launch
cost). Prints one JSON object; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (inserts ROOT/src; --src goes first)


def b2_times(device, gen):
    import torch

    from repro_torch.kernels import quant_matmul as qm

    one = torch.ones((), device=device)
    scale = torch.tensor(0.021, device=device)
    rows = []
    for M, K, N in [(m, 1152, 10) for m in cs.BUCKETS] + [cs.B2_SQUARE]:
        a = torch.randint(-128, 128, (M, K), generator=gen,
                          dtype=torch.int8).to(device)
        b = torch.randint(-128, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(device)
        # torch._int_mm takes M > 16 and K, N multiples of 8
        a_pad = torch.zeros((max(M, 32), K), dtype=torch.int8, device=device)
        a_pad[:M] = a
        b_pad = torch.zeros((K, -(-N // 8) * 8), dtype=torch.int8,
                            device=device)
        b_pad[:, :N] = b

        def kernel(a=a, b=b):
            return qm.quant_matmul_cuda(a, b, one, scale)

        def library(a_pad=a_pad, b_pad=b_pad, M=M, N=N):
            return torch._int_mm(a_pad, b_pad)[:M, :N].float() * (one * scale)

        cs.check(torch.equal(kernel(), library()),
                 f"B2 ({M}, {K}, {N}): the kernel differs from torch._int_mm")
        rows.append(dict(M=M, K=K, N=N, ms=cs.time_ms(kernel),
                         device_ms=cs.device_ms(kernel, ("quant_matmul",)),
                         library_ms=cs.time_ms(library),
                         library_device_ms=cs.device_ms(library, ("",))))
    return rows


def serve_stages(device):
    """chip_smoke.py's stage inputs: (name, ConvPlan, occupancy, weights) of
    every event-driven stage of the full-width net on 64 images."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.snn_model import init_params
    from repro_torch.data.synthetic import make_cifar_like

    params = init_params(torch.Generator().manual_seed(cs.SEED), cs.SPEC,
                         cs.HW, cs.C_IN, device=device)
    th = tuple(torch.ones((), device=device) for _ in params)
    cfg = engine.SNNConfig(spec=cs.SPEC, input_hw=cs.HW, input_c=cs.C_IN,
                           T=cs.T, mode=cs.MODE, depth=cs.DEPTH)
    imgs = torch.as_tensor(make_cifar_like(64, seed=cs.SEED + 3)[0],
                           device=device)
    return cs.stage_inputs(params, th, cfg, imgs)[0]


def b1_b3_times(device):
    from repro_torch.kernels import spike_pipeline as sp
    from repro_torch.kernels import spike_sparse as ss

    rows = []
    for name, cp, occ, w in serve_stages(device):
        if name.startswith("conv0"):
            continue                   # the binary-input stage: not analog
        kw = dict(K=cp.kernel, n_win=cp.fmt.n_win, depth=cs.DEPTH,
                  H=cp.in_hw, W=cp.in_hw)

        def b1(occ=occ, w=w, kw=kw):
            return sp.fused_spike_accum_cuda(occ, w, steps=cs.T, **kw)

        def b3(occ=occ, w=w, kw=kw, wb=None):
            return ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=wb,
                                                    **kw)

        rows.append(dict(
            stage=name, b1_ms=cs.time_ms(b1),
            b1_device_ms=cs.device_ms(b1, ("fused_spike_accum", "Memset")),
            b3_device_ms=cs.device_ms(b3, ("sparse_",)),
            b3_w8_device_ms=cs.device_ms(lambda: b3(wb=8), ("sparse_",))))
    return rows


def b4_times(device):
    import torch

    from repro_torch.kernels import event_accum as ea
    from repro_torch.kernels import spike_compact as sc

    stages = serve_stages(device)
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    rows = []
    for name, cp, occ, w in stages:
        if name.startswith("conv0"):
            continue                   # the binary-input stage: not analog
        fmt = cp.fmt
        N, C, K2, P = occ.shape
        words, total = sc.spike_compact_cuda(
            occ.reshape(-1, P), n_win=fmt.n_win, bits=fmt.bits_coord,
            depth=cs.DEPTH, invalid=fmt.invalid_word)
        B = N // cs.T
        words = words.reshape(B, cs.T, C, K2, cs.DEPTH)
        counts = torch.clamp(total, max=cs.DEPTH).reshape(B, cs.T, C, K2)
        vm = torch.randn((B, cp.in_hw, cp.in_hw, cp.out_c),
                         generator=gen).to(device)
        kw = dict(K=cp.kernel, n_win=fmt.n_win, bits=fmt.bits_coord)
        ms = dev = decode = 0.0
        for t in range(cs.T):
            def accum(wt=words[:, t], ct=counts[:, t]):
                return ea.event_accum_cuda(wt, ct, w, vm, **kw)

            ms += cs.time_ms(accum)
            dev += cs.device_ms(accum, ("event_accum",))
            decode += cs.device_ms(accum, ("event_accum_decode",))
        rows.append(dict(stage=name, ms=ms, device_ms=dev,
                         decode_device_ms=decode))
    return rows


def b6_times(device, gen):
    import torch

    from repro_torch.kernels import moe_gather as mg

    rows = []
    for t, d, s, dtype in ((1024, 128, 512, torch.float32),
                           (4096, 4096, 8192, torch.bfloat16)):
        x = torch.randn((t, d), generator=gen).to(dtype).to(device)
        idx = torch.randint(-1, t, (s,), generator=gen,
                            dtype=torch.int32).to(device)
        x_pad = torch.cat([x, x.new_zeros((1, d))])
        idx_pad = torch.where(idx < 0, t, idx)

        def kernel(x=x, idx=idx):
            return mg.moe_gather_cuda(x, idx)

        def library(x_pad=x_pad, idx_pad=idx_pad):
            return torch.index_select(x_pad, 0, idx_pad)

        cs.check(torch.equal(kernel(), library()),
                 f"B6 ({t}, {d}, {s}): the kernel differs from index_select")
        esize = x.element_size()
        used = int(torch.unique(idx[idx >= 0]).numel())
        nbytes = used * d * esize + s * d * esize + s * 4
        rows.append(dict(T=t, d=d, S=s, dtype=str(dtype).split(".")[-1],
                         bytes=nbytes, bound_ms=cs.bound(nbytes, 0, 1.0)[0],
                         ms=cs.time_ms(kernel),
                         device_ms=cs.device_ms(kernel, ("moe_gather",)),
                         library_ms=cs.time_ms(library),
                         library_device_ms=cs.device_ms(library, ("",))))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree whose kernels run")
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default="b1,b2,b3,b4,b6",
                    help="comma-separated subset of b1,b2,b3,b4,b6 (b1 "
                         "also times b3)")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _cuda

    device = resolve_device("cuda")
    _cuda.build_all()
    gen = torch.Generator().manual_seed(cs.SEED + 6)
    result = dict(tag=args.tag, src=str(Path(repro_torch.__file__).parent),
                  device=torch.cuda.get_device_name(0))
    if want & {"b1", "b3"}:
        result["b1_b3"] = b1_b3_times(device)
        for k in ("b1_device_ms", "b3_device_ms", "b3_w8_device_ms"):
            result[k] = sum(r[k] for r in result["b1_b3"])
    if "b2" in want:
        result["b2"] = b2_times(device, gen)
    if "b4" in want:
        result["b4"] = b4_times(device)
        result["b4_device_ms"] = sum(r["device_ms"] for r in result["b4"])
        result["b4_ms"] = sum(r["ms"] for r in result["b4"])
    if "b6" in want:
        result["b6"] = b6_times(device, gen)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
