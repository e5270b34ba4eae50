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
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ref
from repro_torch.kernels import spike_pipeline as sp
from repro_torch.kernels import spike_sparse as ss

B1_SHAPES = [  # (hw, c_in, c_out, depth), as tests/test_torch_kernels.py
    (9, 1, 8, 16), (12, 3, 16, 4), (28, 4, 32, 64), (10, 2, 8, 2),
    (6, 1, 4, 16), (9, 2, 8, 4), (10, 1, 8, 3), (32, 3, 40, 64),
]
B2_SHAPES = [(16, 32, 8), (100, 200, 60), (128, 128, 128), (130, 257, 64),
             (1, 1152, 10), (64, 1152, 10)]


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
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    sa, sb = torch.tensor(0.013), torch.tensor(0.021)
    got = qm.quant_matmul_cuda(*(t.to(cuda) for t in (a, b, sa, sb)))
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
    lg, sg = engine.infer_batch(params, th, cfg, imgs, device=cuda)
    lc, sc = engine.infer_batch(params, th, cfg, imgs, device="cpu")
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
        got = ss.fused_spike_accum_sparse_cuda(occ, w_g, bits=fmt.bits_coord,
                                               weight_bits=wb, **kw)
        assert torch.equal(got, ss.fused_spike_accum_sparse_plain(
            occ, w_g, e_cap=e_cap, weight_bits=wb, **kw))
        assert torch.equal(got, ref.fused_spike_accum_quant_ref(
            occ, w_g, weight_bits=wb, **kw))
    got = ss.fused_spike_accum_sparse_cuda(occ, w_g, bits=fmt.bits_coord,
                                           **kw)
    want = ss.fused_spike_accum_sparse_plain(occ, w_g, e_cap=e_cap, **kw)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, sp.fused_spike_accum_cuda(
        occ, w_g, bits=fmt.bits_coord, **kw))


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
            occ, w_dy, bits=fmt.bits_coord, n_rows=n_rows,
            weight_bits=weight_bits, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[~keep].any()
    empty = torch.zeros_like(occ)
    for n_rows in (0, 8):
        got = ss.fused_spike_accum_sparse_cuda(
            empty, w_dy, bits=fmt.bits_coord, n_rows=n_rows,
            weight_bits=weight_bits, **kw)
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
@pytest.mark.parametrize("backend", ["queue_pallas", "queue_sparse"])
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
