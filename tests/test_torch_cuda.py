"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode), carries
the ``cuda`` marker and skips without one. The file imports neither jax nor
the reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.aeq import phase_occupancy
from repro_torch.core.encoding import make_format
from repro_torch.device import resolve_device
from repro_torch.core import aeq
from repro_torch.kernels import event_accum as ea
from repro_torch.kernels import moe_gather as mg
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ref
from repro_torch.kernels import spike_compact as sc
from repro_torch.kernels import spike_pipeline as sp
from repro_torch.kernels import spike_sparse as ss

from _torch_queues import repeated_queues

B1_SHAPES = [  # (hw, c_in, c_out, depth), as tests/test_torch_kernels.py
    (9, 1, 8, 16), (12, 3, 16, 4), (28, 4, 32, 64), (10, 2, 8, 2),
    (6, 1, 4, 16), (9, 2, 8, 4), (10, 1, 8, 3), (32, 3, 40, 64),
]
B2_SHAPES = [(16, 32, 8), (100, 200, 60), (128, 128, 128), (130, 257, 64),
             (1, 1152, 10), (64, 1152, 10),
             # the head's buckets past a 16-row tile, ragged K, the square
             # shape of kernel_bench, and K and N below one mma tile
             (3, 1152, 10), (17, 1153, 10), (65, 1152, 10), (256, 256, 256),
             (5, 31, 3)]
B4_SHAPES = [  # (hw, c_in, c_out, depth): tests/test_torch_word.py, + 32x32
    (9, 1, 8, 16), (12, 3, 16, 32), (28, 4, 32, 64), (28, 2, 128, 24),
    (10, 3, 8, 4), (32, 3, 40, 64)]
B5_SHAPES = [  # (rows, n_win, depth): tests/test_kernels.py, + wide rows,
    # + P in {1, 16, 121} over thousands of rows, depth not a multiple of 4
    # and rows not a multiple of a block's (128 at P = 1, 16 at P = 16, 8 at
    # P = 121, at depth 64)
    (4, 4, 8), (9, 10, 40), (18, 10, 16), (2000, 11, 64), (300, 4, 2),
    (5000, 1, 64), (4097, 1, 3), (3001, 4, 7), (2003, 11, 61)]
B4_GATHER_SHAPES = [  # (hw, c_in, c_out, depth, K, rows): K in {1, 3, 5, 7},
    # a 3x3 stage and 64x64 maps; 8 window cells a block where the grid of
    # such blocks covers the 132 SMs (32x32 at 8 rows, 64x64 at 3 rows),
    # else 2
    (9, 2, 8, 16, 3, 3), (10, 3, 40, 4, 3, 3), (32, 3, 40, 64, 3, 8),
    (3, 64, 128, 64, 3, 64), (9, 2, 8, 4, 1, 3), (10, 3, 40, 64, 1, 3),
    (11, 2, 8, 3, 5, 3), (20, 3, 16, 64, 5, 3), (14, 2, 8, 2, 7, 3),
    (28, 3, 40, 64, 7, 3), (64, 32, 32, 64, 3, 2), (64, 8, 40, 16, 3, 3)]
B6_SHAPES = [(16, 8, 12), (64, 32, 50), (10, 128, 40), (1024, 128, 512),
             (7, 3, 9),
             # rows of 148 / 74 / 37 bytes (no 16-byte unit), and rows of
             # 512 B to 2 KiB over 8192 slots (the bulk path's ring turns)
             (9, 37, 21), (4096, 512, 8192)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth", B1_SHAPES)
def test_fused_spike_accum_kernel_matches_plain(cuda, hw, c_in, c_out, depth):
    """Dyadic weights: bit-exact against the plain version and the scatter
    oracle; the launch counter counts the one launch."""
    rng = np.random.default_rng(hw * depth + c_in)
    raster = torch.from_numpy(
        (rng.random((3, hw, hw, c_in)) < 0.25).astype(np.float32)).to(cuda)
    fmt = make_format(hw, 3)
    occ = phase_occupancy(fmt, raster)
    w = torch.from_numpy(
        (rng.integers(-128, 128, (3, 3, c_in, c_out)) / 256.0)
        .astype(np.float32)).to(cuda)
    kw = dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    ops.reset_launch_counts()
    got = ops.fused_spike_accum(occ, w, bits=fmt.bits_coord, **kw)
    assert ops.launch_counts["fused_spike_accum"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, sp.fused_spike_accum_plain(occ, w, **kw))
    assert torch.equal(got, ref.fused_spike_accum_ref(occ, w, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", B2_SHAPES)
def test_quant_matmul_kernel_bit_exact(cuda, m, k, n):
    """Bit-exact against the oracle at any M, K, N (masked in the kernel),
    in one launch."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    sa, sb = torch.tensor(0.013), torch.tensor(0.021)
    ops.reset_launch_counts()
    got = ops.quant_matmul(*(t.to(cuda) for t in (a, b, sa, sb)))
    assert ops.launch_counts["quant_matmul"] == 1
    assert torch.equal(got.cpu(), ref.quant_matmul_ref(a, b, sa, sb))


@pytest.mark.cuda
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_engine_on_card_equals_cpu_on_dyadic_net(cuda, weight_bits):
    """The whole queue_pallas path on the card (kernels) == on the CPU
    (plain versions), logits and stats, on a small dyadic net."""
    spec, hw, c = "6C3-P2-8C3-P3-10", 12, 2
    rng = np.random.default_rng(0)
    plan = engine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.integers(-96, 97, (3, 3, cp.in_c, cp.out_c)) / 256.0,
            "b": np.full(cp.out_c, 0.0625)}
    w = rng.integers(-127, 128, (plan.out.n_in, 10))
    w.flat[0] = 127
    params[plan.out.index] = {"w": w / 256.0, "b": np.zeros(10)}
    th = [0.5] * plan.n_layers
    imgs = (rng.integers(0, 256, (5, hw, hw, c)) / 256.0).astype(np.float32)
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
                           mode="mttfs", weight_bits=weight_bits)
    lg, sg = engine.infer_batch(params, th, cfg, imgs, backend="queue_pallas",
                                device=cuda)
    lc, sc = engine.infer_batch(params, th, cfg, imgs, backend="queue_pallas",
                                device="cpu")
    assert torch.equal(lg.cpu(), lc)
    for a, b in zip(sg, sc):
        assert torch.equal(a.cpu(), b)


def _b3_inputs(cuda, hw, c_in, c_out, n, seed, p_fire=0.25):
    rng = np.random.default_rng(seed)
    raster = torch.from_numpy(
        (rng.random((n, hw, hw, c_in)) < p_fire).astype(np.float32)).to(cuda)
    fmt = make_format(hw, 3)
    occ = phase_occupancy(fmt, raster)
    w_dy = torch.from_numpy((rng.integers(-128, 128, (3, 3, c_in, c_out))
                             / 256.0).astype(np.float32)).to(cuda)
    w_g = torch.from_numpy(
        rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)).to(cuda)
    return fmt, occ, w_dy, w_g


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth", B1_SHAPES)
def test_sparse_kernel_matches_plain(cuda, hw, c_in, c_out, depth):
    """B3: fp32 dyadic and int8 bit-exact against the plain version. On
    Gaussian weights it is bit-exact against B1, whose (c, phase) order of
    adds per output it keeps, and within 1e-4 of the plain version, which
    adds in the oracle's offset-major order."""
    fmt, occ, w_dy, w_g = _b3_inputs(cuda, hw, c_in, c_out, 3,
                                     hw * depth + c_in)
    kw = dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    e_cap = ss.max_kept_events(occ.shape, depth)
    ops.reset_launch_counts()
    got = ops.fused_spike_accum(occ, w_dy, bits=fmt.bits_coord,
                                impl="sparse", **kw)
    assert ops.launch_counts["fused_spike_accum_sparse"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ss.fused_spike_accum_sparse_plain(
        occ, w_dy, e_cap=e_cap, **kw))
    for wb in (8, 4):
        got = ss.fused_spike_accum_sparse_cuda(occ, w_g, weight_bits=wb, **kw)
        assert torch.equal(got, ss.fused_spike_accum_sparse_plain(
            occ, w_g, e_cap=e_cap, weight_bits=wb, **kw))
        assert torch.equal(got, ref.fused_spike_accum_quant_ref(
            occ, w_g, weight_bits=wb, **kw))
    got = ss.fused_spike_accum_sparse_cuda(occ, w_g, **kw)
    want = ss.fused_spike_accum_sparse_plain(occ, w_g, e_cap=e_cap, **kw)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, sp.fused_spike_accum_cuda(occ, w_g, **kw))


GATHER_SHAPES = (  # (hw, c_in, c_out, depth, K): B1_SHAPES, other K, 64x64
    [(*shape, 3) for shape in B1_SHAPES]
    + [(9, 2, 8, 4, 1), (10, 3, 40, 64, 1), (11, 2, 8, 3, 5),
       (20, 3, 16, 64, 5), (14, 2, 8, 2, 7), (28, 3, 40, 64, 7),
       (64, 32, 32, 64, 3), (64, 32, 32, 16, 3)])


def _gather_inputs(cuda, hw, c_in, c_out, K, n, seed):
    rng = np.random.default_rng(seed)
    raster = torch.from_numpy(
        (rng.random((n, hw, hw, c_in)) < 0.25).astype(np.float32)).to(cuda)
    fmt = make_format(hw, K)
    w = torch.from_numpy(
        rng.normal(size=(K, K, c_in, c_out)).astype(np.float32)).to(cuda)
    return fmt, phase_occupancy(fmt, raster).contiguous(), w


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth,K", GATHER_SHAPES)
def test_gather_kernels_match_ordered_oracle(cuda, hw, c_in, c_out, depth,
                                             K):
    """B1 and B3 on Gaussian weights equal the (c, phase)-ordered oracle bit
    for bit (the order of adds the mask contract and B3 == B1 rest on), and
    B3's int path equals the quantized oracle, at K in {1, 3, 5, 7}, depth
    < P and a 64x64 map (whose charge map no block could hold)."""
    n = 2 if hw == 64 else 3
    fmt, occ, w = _gather_inputs(cuda, hw, c_in, c_out, K, n, hw + depth + K)
    kw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    want = ref.fused_spike_accum_ordered_ref(occ, w, **kw)
    b1 = sp.fused_spike_accum_cuda(occ, w, **kw)
    b3 = ss.fused_spike_accum_sparse_cuda(occ, w, **kw)
    q = ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(b1, want) and torch.equal(b3, want)
    assert torch.equal(q, ref.fused_spike_accum_quant_ref(
        occ, w, weight_bits=8, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n_act", [0, 1, 2])
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_gather_sparse_ragged_rows_match_oracles(cuda, n_act, weight_bits):
    """B3 over N = 16 rows of which n_act in {0, 1, N/8} hold events, with
    n_rows = n_act: bit-exact against the ordered oracle (fp32) or the
    quantized one (int path); the idle rows are exact zeros."""
    hw, c_in, c_out, depth = 12, 3, 40, 16
    fmt, occ, w = _gather_inputs(cuda, hw, c_in, c_out, 3, 16, 7 + n_act)
    keep = torch.zeros(16, dtype=torch.bool, device=cuda)
    keep[[5, 11][:n_act]] = True
    occ = (occ * keep[:, None, None, None]).contiguous()
    kw = dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    got = ss.fused_spike_accum_sparse_cuda(
        occ, w, n_rows=n_act, weight_bits=weight_bits, **kw)
    torch.cuda.synchronize()
    if weight_bits is None:
        want = ref.fused_spike_accum_ordered_ref(occ, w, **kw)
    else:
        want = ref.fused_spike_accum_quant_ref(occ, w,
                                               weight_bits=weight_bits, **kw)
    assert torch.equal(got, want)
    assert not got[~keep].any()


@pytest.mark.cuda
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_sparse_kernel_ragged_rows(cuda, weight_bits):
    """Rows 1, 4 and 6 of 8 hold events: with n_rows = 3 only they run, the
    others come back exact zeros; the same with n_rows = N and all-empty
    occupancy."""
    hw, c_in, c_out, depth = 12, 3, 40, 16
    fmt, occ, w_dy, _ = _b3_inputs(cuda, hw, c_in, c_out, 8, 5)
    keep = torch.zeros(8, dtype=torch.bool, device=cuda)
    keep[[1, 4, 6]] = True
    occ = (occ * keep[:, None, None, None]).contiguous()
    kw = dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    want = ss.fused_spike_accum_sparse_plain(
        occ, w_dy, e_cap=ss.max_kept_events(occ.shape, depth),
        weight_bits=weight_bits, **kw)
    for n_rows in (3, 8):
        got = ss.fused_spike_accum_sparse_cuda(
            occ, w_dy, n_rows=n_rows, weight_bits=weight_bits, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[~keep].any()
    empty = torch.zeros_like(occ)
    for n_rows in (0, 8):
        got = ss.fused_spike_accum_sparse_cuda(
            empty, w_dy, n_rows=n_rows, weight_bits=weight_bits, **kw)
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_queue_sparse_on_card_equals_cpu_on_dyadic_net(cuda, input_mode,
                                                      weight_bits):
    """queue_sparse on the card (B3) == on the CPU (plain event list), and
    == queue_ref on the card, logits and stats, on a small dyadic net."""
    spec, hw, c = "6C3-P2-8C3-P3-10", 12, 2
    rng = np.random.default_rng(1)
    plan = engine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.integers(-96, 97, (3, 3, cp.in_c, cp.out_c)) / 256.0,
            "b": np.full(cp.out_c, 0.0625)}
    w = rng.integers(-127, 128, (plan.out.n_in, 10))
    w.flat[0] = 127
    params[plan.out.index] = {"w": w / 256.0, "b": np.zeros(10)}
    th = [0.5] * plan.n_layers
    imgs = (rng.integers(0, 256, (5, hw, hw, c)) / 256.0).astype(np.float32)
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
                           mode="mttfs_cont", input_mode=input_mode,
                           weight_bits=weight_bits)
    ops.reset_launch_counts()
    lg, sg = engine.infer_batch(params, th, cfg, imgs, backend="queue_sparse",
                                device=cuda)
    n_event_stages = len(plan.convs) - (input_mode == "analog")
    assert ops.launch_counts["fused_spike_accum_sparse"] == n_event_stages
    assert ops.launch_counts["fused_spike_accum"] == 0
    lc, sc = engine.infer_batch(params, th, cfg, imgs, backend="queue_sparse",
                                device="cpu")
    lr, sr = engine.infer_batch(params, th, cfg, imgs, backend="queue_ref",
                                device=cuda)
    assert torch.equal(lg.cpu(), lc) and torch.equal(lg, lr)
    for a, b, r in zip(sg, sc, sr):
        assert torch.equal(a.cpu(), b) and torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["queue_pallas", "queue_sparse", "queue",
                                     "dense", "dense_unrolled"])
def test_fp32_head_mask_contract_gaussian_bucket_64(cuda, backend):
    """Gaussian weights, fp32 head: 33 valid rows of a bucket of 64 equal
    the unpadded call of 33 rows, bit for bit (the head multiplies
    fixed-shape tiles, so cuBLAS sees the same M either way)."""
    spec, hw, c = "8C3-P2-16C3-P3-10", 12, 2
    rng = np.random.default_rng(3)
    plan = engine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.normal(0, 0.5, (3, 3, cp.in_c, cp.out_c)),
            "b": np.full(cp.out_c, 0.05)}
    params[plan.out.index] = {"w": rng.normal(size=(plan.out.n_in, 10)),
                              "b": np.zeros(10)}
    th = [1.0] * plan.n_layers
    imgs = rng.random((64, hw, hw, c)).astype(np.float32)
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=4, depth=64,
                           mode="mttfs_cont")
    lp, sp_ = engine.infer_batch_masked(params, th, cfg, imgs, 33,
                                        backend=backend, device=cuda)
    lu, su = engine.infer_batch(params, th, cfg, imgs[:33], backend=backend,
                                device=cuda)
    assert torch.equal(lp, lu)
    for a, b in zip(sp_, su):
        assert torch.equal(a, b)


def _dyadic_net(spec, hw, c, seed):
    rng = np.random.default_rng(seed)
    plan = engine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.integers(-96, 97, (3, 3, cp.in_c, cp.out_c)) / 256.0,
            "b": np.full(cp.out_c, 0.0625)}
    w = rng.integers(-127, 128, (plan.out.n_in, 10))
    w.flat[0] = 127
    params[plan.out.index] = {"w": w / 256.0, "b": np.zeros(10)}
    imgs = (rng.integers(0, 256, (5, hw, hw, c)) / 256.0).astype(np.float32)
    return plan, params, [0.5] * plan.n_layers, imgs


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_win,depth", B5_SHAPES)
def test_spike_compact_kernel_bit_exact(cuda, rows, n_win, depth):
    """B5: words and uncapped counts equal the plain version and the
    oracle, in the compressed and the uncompressed (n_win = 4) format."""
    fmt = make_format(n_win * 3, 3)
    occ = torch.from_numpy((np.random.default_rng(rows).random(
        (rows, n_win * n_win)) < 0.3).astype(np.int32)).to(cuda)
    kw = dict(n_win=n_win, bits=fmt.bits_coord, depth=depth,
              invalid=fmt.invalid_word)
    ops.reset_launch_counts()
    words, counts = ops.spike_compact(occ, **kw)
    assert ops.launch_counts["spike_compact"] == 1
    torch.cuda.synchronize()
    for want in (sc.spike_compact_plain(occ, **kw),
                 ref.spike_compact_ref(occ, **kw)):
        assert torch.equal(words, want[0]) and torch.equal(counts, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth", B4_SHAPES)
def test_event_accum_kernel_matches_plain(cuda, hw, c_in, c_out, depth):
    """B4 over a step's slice of a (B, T, C, K2, D) queue: dyadic weights
    bit-exact against the plain version and the oracle; Gaussian weights
    within 1e-4 (the kernel adds in (c, phase) order, the plain version
    offset by offset); each row equals its launch alone."""
    rng = np.random.default_rng(hw * depth + c_in)
    raster = torch.from_numpy((rng.random((3, 2, c_in, hw, hw)) < 0.2)
                              .astype(np.float32)).to(cuda)
    fmt = make_format(hw, 3)
    q = aeq.aeq_from_raster_batch(fmt, raster, depth)
    words, counts = q.words[:, 1], q.counts[:, 1]      # strided rows
    kw = dict(K=3, n_win=fmt.n_win, bits=fmt.bits_coord)
    vm = torch.from_numpy(
        (np.round(rng.normal(size=(3, hw, hw, c_out)) * 16) / 16)
        .astype(np.float32)).to(cuda)
    w_dy = torch.from_numpy((rng.integers(-128, 128, (3, 3, c_in, c_out))
                             / 256.0).astype(np.float32)).to(cuda)
    w_g = torch.from_numpy(
        rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)).to(cuda)
    ops.reset_launch_counts()
    got = ops.event_accum(words, counts, w_dy, vm, **kw)
    assert ops.launch_counts["event_accum"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ea.event_accum_plain(words, counts, w_dy, vm,
                                                 **kw))
    for n in range(3):
        assert torch.equal(got[n], ref.event_accum_ref(
            words[n], counts[n], w_dy, vm[n], **kw))
    got = ea.event_accum_cuda(words, counts, w_g, vm, **kw)
    want = ea.event_accum_plain(words, counts, w_g, vm, **kw)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    for n in range(3):
        one = ea.event_accum_cuda(words[n:n + 1], counts[n:n + 1], w_g,
                                  vm[n:n + 1].contiguous(), **kw)
        assert torch.equal(one[0], got[n])


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth", B4_SHAPES)
def test_event_accum_kernel_bf16(cuda, hw, c_in, c_out, depth):
    """B4 in bf16. Weights and membrane on a 1/4 grid (|w| <= 1, |v| <=
    2, at most 36 adds) keep every partial sum within bf16's 8 bits, so the
    kernel equals the bf16 plain version bit for bit. On Gaussian weights
    the two add in other orders; each order's rounded sum of m terms lies
    within gamma_m * sum|x| of the exact one (u = 2^-8, gamma_m = m u / (1
    - m u)), so they are held to twice that. From a zero membrane the
    kernel equals the (c, phase)-ordered oracle in bf16 bit for bit."""
    rng = np.random.default_rng(hw * depth + c_in + 1)
    raster = torch.from_numpy((rng.random((3, 2, c_in, hw, hw)) < 0.2)
                              .astype(np.float32)).to(cuda)
    fmt = make_format(hw, 3)
    q = aeq.aeq_from_raster_batch(fmt, raster, depth)
    words, counts = q.words[:, 1], q.counts[:, 1]      # strided rows
    kw = dict(K=3, n_win=fmt.n_win, bits=fmt.bits_coord)
    w_q = torch.from_numpy((rng.integers(-4, 5, (3, 3, c_in, c_out)) / 4.0)
                           .astype(np.float32)).to(cuda).bfloat16()
    vm_q = torch.from_numpy((rng.integers(-8, 9, (3, hw, hw, c_out)) / 4.0)
                            .astype(np.float32)).to(cuda).bfloat16()
    ops.reset_launch_counts()
    got = ops.event_accum(words, counts, w_q, vm_q, **kw)
    assert ops.launch_counts["event_accum"] == 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ea.event_accum_plain(words, counts, w_q, vm_q,
                                                 **kw))
    w_g = torch.from_numpy(rng.normal(size=(3, 3, c_in, c_out))
                           .astype(np.float32)).to(cuda)
    vm_g = torch.from_numpy(rng.normal(size=(3, hw, hw, c_out))
                            .astype(np.float32)).to(cuda)
    w16, vm16 = w_g.bfloat16(), vm_g.bfloat16()
    got = ea.event_accum_cuda(words, counts, w16, vm16, **kw)
    want = ea.event_accum_plain(words, counts, w16, vm16, **kw)
    m = ea.event_accum_plain(words, counts, torch.ones_like(w_g),
                             torch.zeros_like(vm_g), **kw)
    abs_sum = ea.event_accum_plain(words, counts, w16.float().abs(),
                                   vm16.float().abs(), **kw)
    u = 2.0 ** -8
    assert float(m.max()) * u < 1
    tol = 2 * m * u / (1 - m * u) * abs_sum
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    zero = ea.event_accum_cuda(words, counts, w16, torch.zeros_like(vm16),
                               **kw)
    occ = phase_occupancy(fmt, raster[:, 1].permute(0, 2, 3, 1))
    assert torch.equal(zero, ref.fused_spike_accum_ordered_ref(
        occ, w16, K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,depth,K,rows", B4_GATHER_SHAPES)
def test_event_accum_kernel_matches_ordered_oracle(cuda, hw, c_in, c_out,
                                                   depth, K, rows):
    """B4 on Gaussian weights, over a step's slice of a (B, T, C, K2, D)
    queue: its decode's bits equal ``event_bits_plain``; fp32 and bf16
    equal the (c, phase)-ordered oracle started from the membrane bit for
    bit (the order of adds of the scatter form it replaced); every row
    equals its launch alone (another block width, the same result)."""
    rng = np.random.default_rng(hw * depth + K + rows)
    raster = torch.from_numpy((rng.random((rows, 2, c_in, hw, hw)) < 0.2)
                              .astype(np.float32)).to(cuda)
    fmt = make_format(hw, K)
    q = aeq.aeq_from_raster_batch(fmt, raster, depth)
    words, counts = q.words[:, 1], q.counts[:, 1]      # strided rows
    occ = phase_occupancy(fmt, raster[:, 1].permute(0, 2, 3, 1))
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    okw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    w = torch.from_numpy(rng.normal(size=(K, K, c_in, c_out))
                         .astype(np.float32)).to(cuda)
    vm = torch.from_numpy(rng.normal(size=(rows, hw, hw, c_out))
                          .astype(np.float32)).to(cuda)
    bits = torch.empty((rows, c_in, K * K, -(-fmt.n_win ** 2 // 32)),
                       dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ea.event_accum_cuda(words, counts, w, vm, bits_out=bits, **kw)
    assert ops.launch_counts["event_accum"] == 1
    torch.cuda.synchronize()
    assert torch.equal(bits, ea.event_bits_plain(
        words, counts, n_win=fmt.n_win, bits=fmt.bits_coord))
    assert torch.equal(got, ref.fused_spike_accum_ordered_ref(
        occ, w, init=vm, **okw))
    for n in range(rows):
        one = ea.event_accum_cuda(words[n:n + 1], counts[n:n + 1], w,
                                  vm[n:n + 1].contiguous(), **kw)
        assert torch.equal(one[0], got[n])
    w16, vm16 = w.bfloat16(), vm.bfloat16()
    got16 = ea.event_accum_cuda(words, counts, w16, vm16, **kw)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, ref.fused_spike_accum_ordered_ref(
        occ, w16, init=vm16, **okw))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,s", B6_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
def test_moe_gather_kernel_bit_exact(cuda, t, d, s, dtype):
    rng = np.random.default_rng(t + d)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32) * 50)
    x = x.to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(-1, t, s).astype(np.int32)).to(cuda)
    ops.reset_launch_counts()
    got = ops.moe_gather(x, idx)
    assert ops.launch_counts["moe_gather"] == 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, mg.moe_gather_plain(x, idx))
    assert torch.equal(got, ref.moe_gather_ref(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_moe_gather_kernel_all_slots_empty(cuda, dtype):
    """Every index negative: zero rows only. At d = 1024 every dtype's row
    is 1 KiB or more in 16-byte units (the bulk path); at d = 100 the rows
    of 400, 200 and 100 bytes take the warp copy."""
    for t, d, s in ((64, 1024, 300), (64, 100, 70)):
        x = torch.ones((t, d), dtype=dtype, device=cuda)
        idx = torch.full((s,), -1, dtype=torch.int32, device=cuda)
        ops.reset_launch_counts()
        got = ops.moe_gather(x, idx)
        assert ops.launch_counts["moe_gather"] == 1
        torch.cuda.synchronize()
        assert got.shape == (s, d) and not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,s", [(2048, 2048, 10560), (4, 2048, 480),
                                   (16, 64, 64), (10, 128, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gather_autograd_forward_and_backward(cuda, t, d, s, dtype):
    """``ops.moe_gather`` as the MoE layer calls it (``MoEGather``): the
    forward is one B6 launch, bit-exact to the plain version; the backward
    (``index_add_`` of each live slot's row into its token's row, nothing
    for an empty slot) equals autograd through the plain version: bit for
    bit in fp32 with one slot a token, and in any case within the bound of
    two summation orders (atomics add in any order), 2 (n - 1) 2^-p times
    the sum of the n contributions' magnitudes (p = 24 fp32, 8 bf16).
    Shapes: Qwen1.5-MoE-A2.7B's prefill and decode dispatch, a smoke's."""
    rng = np.random.default_rng(t + s)
    x0 = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    x0 = x0.to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(-1, t, s).astype(np.int32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32))
    cot = cot.to(dtype).to(cuda)
    x = x0.clone().requires_grad_(True)
    ops.reset_launch_counts()
    out = ops.moe_gather(x, idx)
    assert ops.launch_counts["moe_gather"] == 1
    (grad,) = torch.autograd.grad(out, x, cot)
    assert ops.launch_counts["moe_gather"] == 1      # backward is no B6
    torch.cuda.synchronize()
    xp = x0.clone().requires_grad_(True)
    plain = mg.moe_gather_plain(xp, idx)
    (want,) = torch.autograd.grad(plain, xp, cot)
    assert torch.equal(out.detach(), plain.detach())
    live = idx >= 0
    rows = torch.where(live, idx, t).long()
    n = torch.zeros(t + 1, device=cuda).index_add_(
        0, rows, torch.ones(s, device=cuda))[:t, None]
    mag = torch.zeros((t + 1, d), device=cuda).index_add_(
        0, rows, cot.float().abs())[:t]
    p = 24 if dtype == torch.float32 else 8
    bound = 2 * torch.clamp(n - 1, min=0) * 2.0 ** -p * mag
    assert ((grad.float() - want.float()).abs() <= bound).all()
    one = (n[:, 0] <= 1)
    assert torch.equal(grad[one], want[one])


@pytest.mark.cuda
def test_lm_moe_forward_launches_b6_once_a_layer(cuda):
    """The MoE smoke configuration's forward on the card: B6 launches once
    per MoE layer (2) and the logits equal the port's CPU run of the same
    parameters within 8 bf16 ulps of their largest magnitude (cuBLAS and
    the atomics of the combine round apart from the CPU)."""
    from repro_torch.models import model as TM
    from repro_torch.models.moe import MoEConfig
    from repro_torch.training.optimizer import _map

    cfg = TM.ArchConfig(
        name="moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
        kv_heads=4, d_ff=0, vocab=128, act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=96, shared_d_ff=96,
                      every_k_layers=1), remat="none")
    params, _ = TM.init_model(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 16)).astype(np.int32))
    want, _ = TM.forward(params, cfg, {"tokens": toks})
    on_card = _map(lambda t: t.to(cuda), params)
    ops.reset_launch_counts()
    got, _ = TM.forward(on_card, cfg, {"tokens": toks.to(cuda)})
    assert ops.launch_counts["moe_gather"] == 2
    err = (got.float().cpu() - want.float()).abs().max()
    assert err <= 8 * 2.0 ** -8 * want.float().abs().max(), float(err)


B4_REPEAT_SHAPES = [  # (hw, K, c_in, c_out, rows): K in {1, 3, 5, 7}, both
    # AE formats, two channel chunks, and a 3x3 stage (2-cell blocks)
    (9, 3, 2, 8, 3), (12, 3, 3, 40, 3), (32, 3, 40, 40, 8), (3, 3, 64, 128, 64),
    (7, 1, 2, 8, 3), (4, 1, 3, 8, 3), (15, 5, 2, 8, 3), (20, 5, 2, 8, 3),
    (21, 7, 2, 8, 3), (28, 7, 2, 8, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,K,c_in,c_out,rows", B4_REPEAT_SHAPES)
def test_event_accum_kernel_repeated_words(cuda, hw, K, c_in, c_out, rows):
    """B4 on queues that repeat positions (and, where the format leaves
    room, hold off-grid words): fp32 and bf16 on Gaussian weights equal the
    (c, phase)-ordered oracle on the decode's multiplicities bit for bit
    (each occurrence added, back to back); dyadic weights equal the plain
    version bit for bit; every row equals its launch alone."""
    fmt = make_format(hw, K)
    words, counts = repeated_queues(fmt, rows, c_in, 24, hw + K + c_in,
                                    off_grid=fmt.n_win < 1 << fmt.bits_coord)
    words, counts = words.to(cuda), counts.to(cuda)
    rng = np.random.default_rng(hw * K + rows)
    w = torch.from_numpy(rng.normal(size=(K, K, c_in, c_out))
                         .astype(np.float32)).to(cuda)
    vm = torch.from_numpy(rng.normal(size=(rows, hw, hw, c_out))
                          .astype(np.float32)).to(cuda)
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    okw = dict(K=K, n_win=fmt.n_win, depth=fmt.n_win ** 2, H=hw, W=hw,
               multiplicity=True)
    mult = ea.event_mult_plain(words, counts, n_win=fmt.n_win,
                               bits=fmt.bits_coord)
    assert int(mult.max()) >= 2
    ops.reset_launch_counts()
    got = ops.event_accum(words, counts, w, vm, **kw)
    assert ops.launch_counts["event_accum"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref.fused_spike_accum_ordered_ref(
        mult, w, init=vm, **okw))
    for n in range(min(rows, 4)):
        one = ea.event_accum_cuda(words[n:n + 1], counts[n:n + 1], w,
                                  vm[n:n + 1].contiguous(), **kw)
        assert torch.equal(one[0], got[n])
    w16, vm16 = w.bfloat16(), vm.bfloat16()
    got16 = ea.event_accum_cuda(words, counts, w16, vm16, **kw)
    assert torch.equal(got16, ref.fused_spike_accum_ordered_ref(
        mult, w16, init=vm16, **okw))
    w_dy = torch.round(w * 64) / 256
    vm_dy = torch.round(vm * 16) / 16
    assert torch.equal(ea.event_accum_cuda(words, counts, w_dy, vm_dy, **kw),
                       ea.event_accum_plain(words, counts, w_dy, vm_dy, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_queue_on_card_equals_cpu_on_dyadic_net(cuda, input_mode,
                                                weight_bits):
    """The word-level queue on the card (B5 once per event-driven stage, B4
    once per step of each) == on the CPU (plain versions), logits and
    stats; B1 and B3 never run. Per-sample infer equals the batch rows."""
    spec, hw, c = "6C3-P2-8C3-P3-10", 12, 2
    plan, params, th, imgs = _dyadic_net(spec, hw, c, 2)
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
                           mode="mttfs", input_mode=input_mode,
                           weight_bits=weight_bits)
    ops.reset_launch_counts()
    lg, sg = engine.infer_batch(params, th, cfg, imgs, backend="queue",
                                device=cuda)
    stages = len(plan.convs) - (input_mode == "analog")
    assert ops.launch_counts["spike_compact"] == stages
    assert ops.launch_counts["event_accum"] == stages * cfg.T
    assert ops.launch_counts["fused_spike_accum"] == 0
    assert ops.launch_counts["fused_spike_accum_sparse"] == 0
    assert ops.launch_counts["quant_matmul"] == (weight_bits is not None)
    lc, sc_ = engine.infer_batch(params, th, cfg, imgs, backend="queue",
                                 device="cpu")
    assert torch.equal(lg.cpu(), lc)
    for a, b in zip(sg, sc_):
        assert torch.equal(a.cpu(), b)
    for i in (0, 3):
        l1, s1 = engine.infer(params, th, cfg, imgs[i], backend="queue",
                              device=cuda)
        assert torch.equal(l1, lg[i])
        for a, b in zip(s1, sg):
            assert torch.equal(a, b[i])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "dense_unrolled"])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
def test_dense_on_card_equals_cpu_on_dyadic_net(cuda, backend, input_mode):
    spec, hw, c = "6C3-P2-8C3-P3-10", 12, 2
    _, params, th, imgs = _dyadic_net(spec, hw, c, 4)
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
                           mode="mttfs_cont", input_mode=input_mode)
    lg, sg = engine.infer_batch(params, th, cfg, imgs, backend=backend,
                                device=cuda)
    lc, sc_ = engine.infer_batch(params, th, cfg, imgs, backend=backend,
                                 device="cpu")
    assert torch.equal(lg.cpu(), lc)
    for a, b in zip(sg, sc_):
        assert torch.equal(a.cpu(), b)


# --- C3: shapes past the old limits, and the serving graphs -----------------

C3_SHAPES = [  # (hw, c_in, c_out, K, rows, depth): maps past the old
    # staged-bits limit at every unrolled K, and K = 9, 11 (rolled gather)
    (128, 4, 40, 3, 2, 16), (512, 3, 32, 3, 2, 64), (512, 2, 16, 1, 1, 64),
    (512, 2, 16, 5, 1, 64), (512, 2, 16, 7, 1, 64), (32, 3, 40, 9, 3, 16),
    (32, 3, 40, 11, 3, 16), (20, 2, 8, 13, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,K,rows,depth", C3_SHAPES)
def test_c3_gather_kernels_match_ordered_oracle(cuda, hw, c_in, c_out, K,
                                                rows, depth):
    """B1 and B3 equal the (c, phase)-ordered oracle bit for bit, and B3's
    int path the quantized oracle, at maps past the old staged-bits limit
    and at K without an unrolled gather."""
    fmt, occ, w = _gather_inputs(cuda, hw, c_in, c_out, K, rows, hw + K)
    kw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    want = ref.fused_spike_accum_ordered_ref(occ, w, **kw)
    b1 = sp.fused_spike_accum_cuda(occ, w, **kw)
    b3 = ss.fused_spike_accum_sparse_cuda(occ, w, **kw)
    q = ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(b1, want) and torch.equal(b3, want)
    assert torch.equal(q, ref.fused_spike_accum_quant_ref(
        occ, w, weight_bits=8, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,c_out,K,rows,depth", C3_SHAPES)
def test_c3_event_accum_kernel_matches_ordered_oracle(cuda, hw, c_in, c_out,
                                                      K, rows, depth):
    """B4 at the same shapes, over a step's slice of real queues: its
    decode's bits equal ``event_bits_plain``, fp32 and bf16 equal the
    ordered oracle from the membrane bit for bit, and with every live word
    written twice the ordered oracle on the multiplicities."""
    rng = np.random.default_rng(hw + K + rows)
    raster = torch.from_numpy((rng.random((rows, 2, c_in, hw, hw)) < 0.2)
                              .astype(np.float32)).to(cuda)
    fmt = make_format(hw, K)
    q = aeq.aeq_from_raster_batch(fmt, raster, depth)
    words, counts = q.words[:, 1], q.counts[:, 1]
    occ = phase_occupancy(fmt, raster[:, 1].permute(0, 2, 3, 1))
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    okw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)
    w = torch.from_numpy(rng.normal(size=(K, K, c_in, c_out))
                         .astype(np.float32)).to(cuda)
    vm = torch.from_numpy(rng.normal(size=(rows, hw, hw, c_out))
                          .astype(np.float32)).to(cuda)
    bits = torch.empty((rows, c_in, K * K, -(-fmt.n_win ** 2 // 32)),
                       dtype=torch.int32, device=cuda)
    got = ea.event_accum_cuda(words, counts, w, vm, bits_out=bits, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bits, ea.event_bits_plain(
        words, counts, n_win=fmt.n_win, bits=fmt.bits_coord))
    assert torch.equal(got, ref.fused_spike_accum_ordered_ref(
        occ, w, init=vm, **okw))
    w16, vm16 = w.bfloat16(), vm.bfloat16()
    assert torch.equal(ea.event_accum_cuda(words, counts, w16, vm16, **kw),
                       ref.fused_spike_accum_ordered_ref(
                           occ, w16, init=vm16, **okw))
    D = words.shape[-1]
    wr = words[..., torch.arange(D, device=cuda) // 2].contiguous()
    cr = torch.clamp(counts * 2, max=D).contiguous()
    mult = ea.event_mult_plain(wr, cr, n_win=fmt.n_win, bits=fmt.bits_coord)
    assert torch.equal(
        ea.event_accum_cuda(wr, cr, w, vm, **kw),
        ref.fused_spike_accum_ordered_ref(
            mult, w, init=vm, multiplicity=True,
            **{**okw, "depth": fmt.n_win ** 2}))


@pytest.mark.cuda
def test_c3_sparse_w8_sums_in_int32_past_2_24(cuda):
    """B3's int path at K = 7, C_in = 2,720 (K*K*C_in*127 > 2^24: the
    kernel sums int32) equals the quantized oracle bit for bit."""
    fmt, occ, w = _gather_inputs(cuda, 14, 2720, 32, 7, 2, 5)
    assert not ss.int_sums_fit_fp32(7, 2720)
    kw = dict(K=7, n_win=fmt.n_win, depth=4, H=14, W=14)
    got = ss.fused_spike_accum_sparse_cuda(occ, w, weight_bits=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.fused_spike_accum_quant_ref(
        occ, w, weight_bits=8, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_win", [(6, 11), (5, 1), (3, 4)])
def test_c3_spike_compact_past_the_old_depth_limit(cuda, rows, n_win):
    """B5 at depth 65,536 (rows written in place, past one block's shared
    memory) equals its plain version: words and uncapped counts."""
    fmt = make_format(n_win, 1)
    occ = torch.from_numpy((np.random.default_rng(rows).random(
        (rows, n_win * n_win)) < 0.5).astype(np.int32)).to(cuda)
    kw = dict(n_win=n_win, bits=fmt.bits_coord, depth=65_536,
              invalid=fmt.invalid_word)
    got = sc.spike_compact_cuda(occ, **kw)
    want = sc.spike_compact_plain(occ, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,weight_bits", [
    ("queue_pallas", None), ("queue_pallas", 8), ("dense", None),
    ("queue", None)])
def test_graph_replay_equals_eager(cuda, backend, weight_bits):
    """A served bucket is a captured CUDA graph: its replay equals the
    eager ``infer_batch`` of the same rows bit for bit (full and partly
    filled buckets), the capture recorded the wrappers' launches, a second
    warmup pass captures nothing, and a response stays as it was when a
    later replay of the same graph runs."""
    from repro_torch.serve import ModelRegistry

    _, params, th, _ = _dyadic_net("8C3-P2-8C3-P3-10", 12, 2, 3)
    cfg = engine.SNNConfig(spec="8C3-P2-8C3-P3-10", input_hw=12, input_c=2,
                           T=3, depth=4, mode="mttfs_cont",
                           weight_bits=weight_bits)
    h = ModelRegistry(device=cuda).register("m", params, th, cfg,
                                            backend=backend)
    h.warmup((4, 16))
    assert h.compile_count == 2 and h.cached_buckets() == (4, 16)
    if backend == "queue_pallas":             # one event-driven stage
        assert h.plan_launches[4]["fused_spike_accum"] == 1
        assert h.plan_launches[4]["quant_matmul"] == int(weight_bits == 8)
    rng = np.random.default_rng(7)
    imgs = (rng.integers(0, 256, (16, 12, 12, 2)) / 256).astype(np.float32)
    for b in (4, 16):
        for n in (b, b // 2 + 1):
            lr, sr = h.run_bucket(imgs[:b], n)
            le, se = engine.infer_batch(h.params, h.thresholds, cfg,
                                        imgs[:n], backend=backend,
                                        device=cuda)
            assert torch.equal(lr, le)
            assert all(torch.equal(a, c) for a, c in zip(sr, se))
    first, _ = h.run_bucket(imgs[:4], 4)
    kept = first.clone()
    h.run_bucket(imgs[4:8], 4)
    assert torch.equal(first, kept)


@pytest.mark.cuda
def test_load_registry_on_card_replays_bit_equal_to_the_builder(cuda,
                                                                 tmp_path):
    """A registry saved on the card and restored there re-captures every
    saved bucket (``compile_count`` 0, ``cached_buckets`` the ladder, B1
    and, on the w8 handle, B2 in each graph), and each bucket's replay
    equals the builder's graph's bit for bit, fp32 and w8."""
    from repro_torch.serve import ModelRegistry, load_registry, save_registry

    spec = "8C3-P2-8C3-P3-10"
    _, params, th, _ = _dyadic_net(spec, 12, 2, 3)
    rng = np.random.default_rng(8)
    params = [{k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
               for k, v in p.items()} for p in params]   # Gaussian offsets
    cfg = engine.SNNConfig(spec=spec, input_hw=12, input_c=2, T=3, depth=4,
                           mode="mttfs_cont")
    buckets = (1, 4, 16)
    reg = ModelRegistry(device=cuda)
    for name, bits in (("fp32", None), ("w8", 8)):
        reg.register(name, params, th, cfg._replace(weight_bits=bits))
        reg.get(name).warmup(buckets)
    save_registry(reg, str(tmp_path / "registry"))
    restored = load_registry(str(tmp_path / "registry"), device=cuda)
    imgs = rng.random((16, 12, 12, 2)).astype(np.float32)
    for name in ("fp32", "w8"):
        h, built = restored.get(name), reg.get(name)
        assert h.cached_buckets() == buckets and h.compile_count == 0
        for b in buckets:
            assert h.plan_launches[b]["fused_spike_accum"] == 1
            assert h.plan_launches[b]["quant_matmul"] == int(name == "w8")
            for n in sorted({b, b // 2 + 1}):
                lr, sr = h.run_bucket(imgs[:b], n)
                lb, sb = built.run_bucket(imgs[:b], n)
                assert torch.equal(lr, lb)
                assert all(torch.equal(a, c) for a, c in zip(sr, sb))
        h.warmup(buckets)
        assert h.compile_count == 0


@pytest.mark.cuda
def test_fresh_compile_cache_misses_then_hits_in_a_second_process(
        cuda, tmp_path):
    """A fresh ``REPRO_TORCH_COMPILE_CACHE`` directory: the first process
    compiles every source (misses, puts), a second one compiles none."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import _cuda

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src),
               REPRO_TORCH_COMPILE_CACHE=str(tmp_path / "kernels"))
    code = ("import json; from repro_torch.kernels import _cuda; "
            "from repro_torch.core import compile_cache as c; "
            "_cuda.build_all(); _cuda.load('quant_matmul'); "
            "print(json.dumps(c.counters))")
    n = len(_cuda.SOURCES)
    seen = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             check=True, capture_output=True, text=True,
                             timeout=900)
        c = json.loads(out.stdout.strip().splitlines()[-1])
        seen.append((c["hits"], c["misses"], c["puts"]))
    assert seen == [(0, n, n), (n, 0, 0)]


# ---------------------------------------------------------------------------
# the study pipeline on the card
# ---------------------------------------------------------------------------

STUDY_KW = dict(dataset="mnist", net="6C3-P2-8", input_hw=28, input_c=1,
                n_train=256, epochs=2, n_eval=48, eval_seed=99, n_calib=64,
                T=3, depth=64, mode="mttfs_cont", balance=True, batch=16)


def _dyadic_converted(converted):
    """The converted net rounded as chip_smoke's ``dyadic_params``: weights
    to multiples of 2^-8, biases 2^-4, the dense layer's max |w| 127 * 2^-8
    (a power-of-two int8 scale), so no order of adds can flip a spike."""
    from repro_torch.study import ConvertArtifact

    out = []
    params = converted.snn_params
    for i, layer in enumerate(params):
        if not layer:
            out.append({})
            continue
        w = torch.round(layer["w"].cpu() * 256) / 256
        if i == len(params) - 1:
            w = torch.clamp(w, -127 / 256, 127 / 256)
            w[0, 0] = 127 / 256
        out.append({"w": w, "b": torch.round(layer["b"].cpu() * 16) / 16})
    ths = [torch.round(t.cpu() * 16) / 16 for t in converted.thresholds]
    return ConvertArtifact(out, ths, converted.key + "-dyadic")


@pytest.mark.cuda
@pytest.mark.parametrize("net,input_mode,convs", [
    ("6C3-P2-8", "analog", 0), ("6C3-P2-8", "binary", 1),
    ("6C3-P2-8C3-P2-10", "analog", 1)])
@pytest.mark.parametrize("backend,weight_bits", [("queue_pallas", 8),
                                                 ("queue_sparse", 8)])
def test_study_collect_on_card_equals_cpu(cuda, net, input_mode, convs,
                                          backend, weight_bits):
    """The small study's converted net (trained and converted by the port
    on the CPU) and its eval images, rounded to dyadic values:
    ``collect`` on the card equals the port's CPU ``collect`` — integer
    stats equal, logits bit-equal — and launches B1 (``queue_pallas``) or
    B3 (``queue_sparse``) once per event-driven conv stage per batch, and
    the int8 head B2 once a batch where the backend executes
    ``weight_bits`` (``queue_sparse``; on ``queue_pallas`` it prices
    only)."""
    from repro_torch import study

    spec = study.StudySpec(**dict(STUDY_KW, net=net, input_mode=input_mode,
                                  backend=backend, weight_bits=weight_bits))
    cache = study.StudyCache()
    converted = _dyadic_converted(study.convert(spec, cache=cache,
                                                device="cpu"))
    imgs = np.round(spec.load_eval()[0] * 256) / 256
    cpu = study.collect(spec, converted, images=imgs, cache=cache,
                        device="cpu")
    ops.reset_launch_counts()
    gpu = study.collect(spec, converted, images=imgs,
                        cache=study.StudyCache(), device=cuda)
    batches = -(-spec.n_eval // spec.batch)
    accum = ("fused_spike_accum" if backend == "queue_pallas"
             else "fused_spike_accum_sparse")
    assert ops.launch_counts[accum] == convs * batches
    assert ops.launch_counts["quant_matmul"] == (
        batches if backend == "queue_sparse" else 0)
    assert gpu.snn_logits.tobytes() == cpu.snn_logits.tobytes()
    np.testing.assert_array_equal(gpu.snn_pred, cpu.snn_pred)
    for f in study.StatsRecord._fields:
        np.testing.assert_array_equal(getattr(gpu.stats, f),
                                      getattr(cpu.stats, f), err_msg=f)


@pytest.mark.cuda
def test_study_run_on_card_keeps_tf32_off_and_prices(cuda):
    """train / convert / collect / price on the card: TF32 stays off for
    convs and matmuls (``resolve_device``), the trained net stays on the
    card, and the report is finite with the eval set's shape."""
    from repro_torch import study

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    spec = study.StudySpec(**dict(STUDY_KW, backend="queue_pallas"))
    cache = study.StudyCache()
    trained = study.train(spec, cache=cache, device=cuda)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert all(v.device.type == "cuda" for p in trained.params
               for v in p.values())
    converted = study.convert(spec, trained, cache=cache, device=cuda)
    assert all(t.device.type == "cuda" for t in converted.thresholds)
    report = study.run(spec, cache=cache, device=cuda)
    assert report.snn_energy_j.shape == (spec.n_eval,)
    assert np.all(np.isfinite(report.snn_energy_j))
    assert 0.0 <= report.snn_acc <= 1.0 and report.overflow >= 0


@pytest.mark.cuda
def test_train_on_card_is_reproducible(cuda):
    """One recipe trains one net on the card: two fresh trainings of a
    two-conv net give bit-equal params (cuDNN's deterministic algorithms
    inside ``fit_cnn``), and the cuDNN flags are restored after it."""
    from repro_torch import study

    spec = study.StudySpec(**dict(STUDY_KW, net="6C3-P2-8C3-P2-10"))
    before = torch.backends.cudnn.deterministic
    a = study.train(spec, cache=study.StudyCache(), device=cuda)
    b = study.train(spec, cache=study.StudyCache(), device=cuda)
    assert torch.backends.cudnn.deterministic == before
    for la, lb in zip(a.params, b.params):
        for k in la:
            assert torch.equal(la[k], lb[k])


def _digits_batch(n=96):
    from repro_torch.data.synthetic import make_digits

    imgs, labels = make_digits(n, seed=0)
    return np.asarray(imgs), np.asarray(labels)


SNN_FIT_KW = dict(T=2, batch=48, lr=5e-3, rate_reg=0.01, init_seed=3)


@pytest.mark.cuda
def test_fit_snn_on_card_is_reproducible(cuda):
    """Direct training on the card: two runs of one recipe give bit-equal
    params and losses, and the cuDNN flags are restored after each."""
    from repro_torch.training import surrogate

    imgs, labels = _digits_batch()
    before = torch.backends.cudnn.deterministic
    a, _, la = surrogate.fit_snn("4C3-P2-10", imgs, labels, epochs=2,
                                 **SNN_FIT_KW, device=cuda)
    b, _, lb = surrogate.fit_snn("4C3-P2-10", imgs, labels, epochs=2,
                                 **SNN_FIT_KW, device=cuda)
    assert torch.backends.cudnn.deterministic == before
    assert a[0]["w"].device.type == "cuda"
    assert torch.equal(la, lb)
    for pa, pb in zip(a, b):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


@pytest.mark.cuda
def test_fit_snn_resume_on_card_is_bit_exact(cuda, tmp_path):
    """Kill after epoch 2 of 3 and resume from the checkpoints on the card:
    bit-equal to the uninterrupted run, the restored tree on the card."""
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.training import surrogate

    imgs, labels = _digits_batch()
    full, _, _ = surrogate.fit_snn("4C3-P2-10", imgs, labels, epochs=3,
                                   **SNN_FIT_KW, device=cuda)
    ck = str(tmp_path / "ck")
    surrogate.fit_snn("4C3-P2-10", imgs, labels, epochs=2, ckpt_dir=ck,
                      **SNN_FIT_KW, device=cuda)
    assert latest_step(ck) == 2
    resumed, _, _ = surrogate.fit_snn("4C3-P2-10", imgs, labels, epochs=3,
                                      ckpt_dir=ck, **SNN_FIT_KW, device=cuda)
    for pa, pb in zip(full, resumed):
        for k in pa:
            assert pb[k].device.type == "cuda"
            assert torch.equal(pa[k], pb[k])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["if_reset", "mttfs", "mttfs_cont"])
def test_train_forward_gradient_on_card_matches_cpu(cuda, mode):
    """Dyadic params and images (exact forward sums): the card's step
    logits and rates equal the CPU's bit for bit, and its loss and
    gradients match the CPU's within 1e-5 of each gradient's norm (the
    backward sums round in another order). TF32 stays off."""
    from repro_torch.core import snn_model
    from repro_torch.training import surrogate

    spec, hw = "8C3-P2-16C3-P2-10", 16
    rng = np.random.default_rng(0)
    params = snn_model.init_params(torch.Generator().manual_seed(0), spec,
                                   hw, 1, device="cpu")
    params = [{k: torch.round(v * 256) / 256 for k, v in p.items()}
              for p in params]
    x = torch.from_numpy((rng.integers(0, 256, (6, hw, hw, 1)) / 256.0)
                         .astype(np.float32))
    y = torch.arange(6) % 10
    ths = surrogate.unit_thresholds(spec, hw, 1, device="cpu")
    cfg = engine.SNNConfig(spec=spec, input_hw=hw, input_c=1, T=4, mode=mode)
    out = {}
    for dev in ("cpu", cuda):
        p = [{k: v.to(dev).requires_grad_(True) for k, v in layer.items()}
             for layer in params]
        th = [t.to(dev) for t in ths]
        sl, rates = engine.train_forward(p, th, cfg, x.to(dev))
        loss = surrogate.target_loss("train", sl, y.to(dev)) + 0.01 * \
            rates.mean()
        grads = torch.autograd.grad(loss, [v for q in p for v in q.values()])
        out[str(dev)] = (sl.detach().cpu(), rates.detach().cpu(),
                         loss.detach().cpu(), [g.cpu() for g in grads])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    (sl_c, r_c, l_c, g_c), (sl_g, r_g, l_g, g_g) = out["cpu"], out["cuda"]
    assert torch.equal(sl_c, sl_g) and torch.equal(r_c, r_g)
    assert abs(float(l_c) - float(l_g)) <= 1e-6 * abs(float(l_c))
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(a.norm()),
                                                        1e-30)


@pytest.mark.cuda
def test_encode_rate_with_a_cuda_generator(cuda):
    from repro_torch.core.encoding import encode_rate

    img = torch.full((16, 8, 8, 3), 0.5, device=cuda)
    r1 = encode_rate(img, 32, torch.Generator(device=cuda).manual_seed(0))
    r2 = encode_rate(img, 32, torch.Generator(device=cuda).manual_seed(0))
    assert r1.device.type == "cuda" and torch.equal(r1, r2)
    assert abs(float(r1.mean()) - 0.5) < 0.05
    with pytest.raises(ValueError, match="image's device"):
        encode_rate(img, 4, torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("weight_bits", [None, 8])
def test_sharded_equals_one_device_on_card(cuda, weight_bits):
    """``queue_pallas`` at B=64 on a 2-way virtual mesh over the card:
    logits and every stat equal the single-device call bit for bit, B1
    launched 6 times a shard (the CIFAR-10 net's event-driven stages) and
    B2 once a shard on the w8 head; a served bucket 64 over the mesh
    (one graph a shard) answers alike."""
    from repro_torch import parallel
    from repro_torch.core.snn_model import init_params
    from repro_torch.serve import ModelRegistry

    spec = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10"
    params = init_params(torch.Generator().manual_seed(0), spec, 32, 3,
                         device=cuda)
    th = [1.0] * len(params)
    cfg = engine.SNNConfig(spec=spec, input_hw=32, input_c=3, T=4, depth=64,
                           mode="mttfs_cont", weight_bits=weight_bits)
    imgs = np.random.default_rng(3).random((64, 32, 32, 3)).astype(np.float32)
    mesh = parallel.DataMesh((torch.device("cuda", 0),) * 2)
    ref = engine.infer_batch(params, th, cfg, imgs, backend="queue_pallas",
                             device=cuda)
    ops.reset_launch_counts()
    got = parallel.infer_batch_sharded(params, th, cfg, imgs,
                                       backend="queue_pallas", mesh=mesh)
    assert ops.launch_counts["fused_spike_accum"] == 12
    assert ops.launch_counts["quant_matmul"] == 2 * (weight_bits == 8)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    h = ModelRegistry(device=cuda, mesh=mesh).register("m", params, th, cfg)
    lr, sr = h.run_bucket(imgs, 40)
    assert h.plan_launches[64]["fused_spike_accum"] == 12
    assert torch.equal(lr, ref[0][:40])
    assert all(torch.equal(a, b[:40]) for a, b in zip(sr, ref[1]))


@pytest.mark.cuda
def test_sweep_one_pair_on_card(cuda, tmp_path):
    """One (dataset, queue_pallas) pair of the grid at the small study's
    size on the card: the cells complete, share one collect, resume
    without running a stage, and a 2-way mesh over the card gives the same
    rows (``elapsed_s`` aside)."""
    from repro_torch import parallel, study
    from repro_torch.study.sweep import paper_grid, run_sweep

    kw = {k: v for k, v in STUDY_KW.items() if k != "dataset"}
    cells = paper_grid(datasets=(STUDY_KW["dataset"],),
                       backends=("queue_pallas",),
                       pricing=((True, True, 8), (False, False, 4)),
                       overrides=kw)
    study.reset_stage_counts()
    first = run_sweep(cells, out_dir=str(tmp_path / "one"), log=print,
                      cache_dir=str(tmp_path / "cache"))
    assert first["complete"] and dict(study.stage_counts) == {
        "train": 1, "convert": 1, "collect": 1}
    study.reset_stage_counts()
    again = run_sweep(cells, out_dir=str(tmp_path / "one"), log=print,
                      cache_dir=str(tmp_path / "cache"))
    assert again["resumed"] == 2 and dict(study.stage_counts) == {}
    mesh = parallel.DataMesh((torch.device("cuda", 0),) * 2)
    sharded = run_sweep(cells, out_dir=str(tmp_path / "mesh"), mesh=mesh,
                        log=print, cache=study.StudyCache(
                            dir=str(tmp_path / "cache"),
                            disk_kinds=("train", "convert")))

    def rows(s):
        return [{k: v for k, v in r.items() if k != "elapsed_s"}
                for r in s["cells"]]

    assert rows(sharded) == rows(first)


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices (a mesh over distinct "
                    "cards)")
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["queue_pallas", "queue", "dense"])
def test_sharded_over_every_card_equals_one_card(cards, backend):
    """``data_mesh()`` over every visible card: each shard launches its
    kernels on its own card (their shared-memory opt-in is kept per
    device), and logits and stats equal one card's bit for bit, fp32 and
    w8; a bucket served over the mesh answers alike."""
    from repro_torch import parallel
    from repro_torch.core.snn_model import init_params
    from repro_torch.serve import ModelRegistry

    spec = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10"
    params = init_params(torch.Generator().manual_seed(0), spec, 32, 3,
                         device=torch.device("cuda", 0))
    th = [1.0] * len(params)
    imgs = np.random.default_rng(5).random((64, 32, 32, 3)).astype(np.float32)
    mesh = parallel.data_mesh()
    assert parallel.mesh_size(mesh) == cards
    for bits in (None, 8):
        cfg = engine.SNNConfig(spec=spec, input_hw=32, input_c=3, T=4,
                               depth=64, mode="mttfs_cont", weight_bits=bits)
        ref = engine.infer_batch(params, th, cfg, imgs, backend=backend,
                                 device=torch.device("cuda", 0))
        got = parallel.infer_batch_sharded(params, th, cfg, imgs,
                                           backend=backend, mesh=mesh)
        assert got[0].device == torch.device("cuda", 0)
        assert torch.equal(got[0], ref[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        if backend != "queue":                # queue cannot be captured
            h = ModelRegistry(device="cuda:0", mesh=mesh).register(
                "m", params, th, cfg, backend=backend)
            lr, sr = h.run_bucket(imgs, 64)
            assert torch.equal(lr, ref[0])
            assert all(torch.equal(a, b) for a, b in zip(sr, ref[1]))


@pytest.mark.cuda
def test_moe_gather_bulk_path_on_the_last_card(cards):
    """B6's bulk path (rows of 2 KiB, past the 48 KiB shared-memory
    default) on a card other than the first, launched with that card
    current: its opt-in is made there too."""
    dev = torch.device("cuda", cards - 1)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-1, 64, 4096).astype(np.int32)).to(dev)
    with torch.cuda.device(dev):
        got = ops.moe_gather(x, idx)
        torch.cuda.synchronize(dev)
    assert torch.equal(got, mg.moe_gather_plain(x, idx))


@pytest.mark.cuda
def test_audit_on_card(cuda):
    """The port's contract checker on the card: its traced layer has no
    finding outside the baseline (the card-only entries are B2's and B3's
    in-kernel dequants), each kernel's ``smem_blocks`` equals the bytes its
    compiled launcher requests at every paper geometry and at this file's
    gather and queue shapes, and every captured graph holds the launches
    of one eager call and stays captured over a second warmup."""
    from repro_torch.audit import cli, smem

    report = {}
    res = cli.run(cli.repo_root(), device="cuda", report=report)
    assert res.fresh == [], [f.render() for f in res.fresh]
    assert res.stale == []
    graphs = report["graphs"]
    assert graphs and all(r["captured"] == r["eager"] for r in graphs)
    assert any(sum(r["captured"].values()) for r in graphs)
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    gathers = [(hw, c_in, c_out, K, rows, depth)
               for hw, c_in, c_out, depth, K, rows in B4_GATHER_SHAPES]
    rows = smem.compare_launchers(smem.launcher_cases(gathers, B5_SHAPES),
                                  sm_count)
    assert rows and [r for r in rows if not r["equal"]] == []


def _moe_smoke():
    from repro_torch.models import model as TM
    from repro_torch.models.moe import MoEConfig

    return TM.ArchConfig(
        name="moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
        kv_heads=4, d_ff=0, vocab=128, act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=96, shared_d_ff=96,
                      every_k_layers=1), remat="none")


@pytest.mark.cuda
def test_host_mesh_lands_on_the_card(cuda):
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices[0, 0] == torch.device("cuda", 0)


@pytest.mark.cuda
def test_place_and_reshard_on_load_put_params_on_the_card(cuda, tmp_path):
    """``tree_shardings`` of the MoE smoke's params on the host mesh, then
    ``NamedSharding.place`` and ``reshard_on_load`` of a restored
    checkpoint: every leaf on cuda:0, bit-equal to the saved tree."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.sharding.resolver import Resolver
    from repro_torch.training.optimizer import _leaves

    cfg = _moe_smoke()
    params, axes = TM.init_model(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    shardings = Resolver(make_host_mesh()).tree_shardings(params, axes)
    placed = ck._unflatten_like(params, ck._flatten(shardings),
                                leaf=lambda t, s: s.place(t))
    ck.save(str(tmp_path), 1, params)
    restored, _ = ck.restore(str(tmp_path), params)
    loaded = ck.reshard_on_load(restored, shardings)
    for a, b, c in zip(_leaves(params), _leaves(placed), _leaves(loaded)):
        assert b.device == c.device == torch.device("cuda", 0)
        assert torch.equal(a, b.cpu()) and torch.equal(a, c.cpu())


@pytest.mark.cuda
def test_moe_forward_under_a_resolver_is_bit_equal_on_the_card(cuda):
    """The MoE smoke's forward on the card under ``use_resolver`` (host
    mesh) equals its forward without, bit for bit (deterministic
    ``index_add_``), with B6 launched twice in each and the five constrain
    sites recorded per period."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.sharding.resolver import Resolver, use_resolver

    cfg = _moe_smoke()
    params, _ = TM.init_model(torch.Generator(device=cuda).manual_seed(0),
                              cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 16)).astype(np.int32)).to(cuda)
    r = Resolver(make_host_mesh())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            ops.reset_launch_counts()
            plain, _ = TM.forward(params, cfg, {"tokens": toks})
            n_plain = ops.launch_counts["moe_gather"]
            ops.reset_launch_counts()
            with use_resolver(r):
                held, _ = TM.forward(params, cfg, {"tokens": toks})
            n_held = ops.launch_counts["moe_gather"]
    finally:
        torch.use_deterministic_algorithms(False)
    assert n_plain == n_held == 2
    assert torch.equal(plain, held)
    assert len(r.constraints) == 2 + 2 * cfg.n_layers


@pytest.mark.cuda
def test_run_resilient_on_the_card_survives_a_failure(cuda, tmp_path):
    """``run_resilient`` over the MoE smoke's train step on the card: the
    injected failure at step 3 restores the step-2 checkpoint onto the
    card, and the run ends at step 6 with finite losses; B6 launches 2 a
    step execution."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as TM
    from repro_torch.runtime.fault_tolerance import run_resilient
    from repro_torch.training import train_loop as TTL
    from repro_torch.training.optimizer import _leaves

    cfg = _moe_smoke()
    params, _ = TM.init_model(torch.Generator(device=cuda).manual_seed(0),
                              cfg, device=cuda)
    step = TTL.make_train_step(cfg, base_lr=1e-3, warmup=2, total_steps=20)
    launches = []

    def counted(state, batch):
        ops.reset_launch_counts()
        out = step(state, batch)
        launches.append(ops.launch_counts["moe_gather"])
        return out

    state, history = run_resilient(
        train_step=counted, state=TTL.init_state(params),
        batches=iter(TokenStream(cfg.vocab, 16, 4, device=cuda)),
        ckpt_root=str(tmp_path), ckpt_every=2,
        fail_at={3: RuntimeError("injected")}, max_steps=6)
    assert int(state.step) == 6 and len(history) == 7
    assert np.isfinite(history).all()
    assert launches == [2] * 7
    assert all(t.device.type == "cuda" for t in _leaves(state))


def _served_runtime(mesh=None):
    from repro_torch.core.snn_model import init_params
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime

    spec = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10"
    params = init_params(torch.Generator().manual_seed(0), spec, 32, 3,
                         device=torch.device("cuda", 0))
    cfg = engine.SNNConfig(spec=spec, input_hw=32, input_c=3, T=4, depth=64,
                           mode="mttfs_cont")
    registry = ModelRegistry(device="cuda:0")
    handle = registry.register("m", params, [1.0] * len(params), cfg)
    rt = ServeRuntime(registry, BucketPolicy((1, 64)), mesh=mesh)
    handle.warmup((64,))
    imgs = np.random.default_rng(9).random((64, 32, 32, 3)).astype(
        np.float32)
    return rt, imgs


def _serve_steps(rt, imgs, n):
    """``n`` bucket-64 steps; each step's (service_s, {card: device s})."""
    out = []
    for _ in range(n):
        before = rt.stats_summary()["device_s"].get(64, {})
        for im in imgs:
            rt.submit(im, "m")
        (r, *_) = rt.step()
        after = rt.stats_summary()["device_s"][64]
        out.append((r.service_s, {c: s - before.get(c, 0.0)
                                  for c, s in after.items()}))
    return out


@pytest.mark.cuda
def test_served_step_times_its_replay_on_the_card(cuda):
    """A bucket-64 step on the card: ``device_s[64][0]``, the span between
    the replay's timing events, is positive and within the host's
    ``service_s`` around it; under ``torch.profiler`` the replay's B1
    kernels fall between the ``serve.launch`` range's start and the
    ``serve.sync_wait`` range's end, inside ``bench.step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    rt, imgs = _served_runtime()
    for service_s, cards in _serve_steps(rt, imgs, 5):
        assert list(cards) == [0]
        assert 0 < cards[0] <= service_s
    for im in imgs:
        rt.submit(im, "m")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.step"):
            rt.step()
    events = prof.profiler.kineto_results.events()
    cpu = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name() in (
                "bench.step", "serve.launch", "serve.sync_wait"):
            cpu.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    b1 = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
          if e.device_type() == DeviceType.CUDA
          and not e.is_user_annotation()
          and "fused_spike_accum" in e.name()]
    assert len(b1) >= 6, len(b1)
    (launch,) = cpu["serve.launch"]
    (sync,) = cpu["serve.sync_wait"]
    (bench,) = cpu["bench.step"]
    assert bench[0] <= launch[0] <= sync[1] <= bench[1]
    assert all(launch[0] <= s and t <= sync[1] for s, t in b1)


@pytest.mark.cuda
def test_served_step_times_every_card_of_a_mesh(cards):
    """Bucket 64 over a data mesh of every card: each card has its device
    seconds a step, none beyond the step's ``service_s``."""
    from repro_torch import parallel

    rt, imgs = _served_runtime(parallel.data_mesh())
    for service_s, got in _serve_steps(rt, imgs, 5):
        assert sorted(got) == list(range(cards))
        assert all(0 < s <= service_s for s in got.values())
