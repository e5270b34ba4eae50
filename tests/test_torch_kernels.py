"""The port's kernel modules against the JAX reference and the torch oracles.

On the CPU each wrapper runs its kernel's plain version (the tensor's device
decides), so these tests hold the plain versions of B1 (fused spike
accumulate) and B2 (int8 matmul) against the reference realizations and the
oracles of both packages. The CUDA kernels themselves are held against
the plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import encoding as jenc
from repro.kernels import ops as jops
from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spike_pipeline as tsp

B1_SHAPES = [  # (hw, c_in, c_out, depth): tests/test_kernels.py sweeps
    (9, 1, 8, 16), (12, 3, 16, 4), (28, 4, 32, 64), (10, 2, 8, 2),
    (6, 1, 4, 16), (9, 2, 8, 4), (10, 1, 8, 3),
]
B2_SHAPES = [(16, 32, 8), (100, 200, 60), (128, 128, 128), (130, 257, 64),
             (64, 1152, 10)]


def _occ_weights(hw, c_in, c_out, depth, dyadic, T=3, K=3):
    rng = np.random.default_rng(hw * 100 + c_in * 10 + depth + K)
    raster = (rng.random((T, hw, hw, c_in)) < 0.25).astype(np.float32)
    fmt = jenc.make_format(hw, K)
    occ = np.array(jaeq.phase_occupancy(fmt, jnp.asarray(raster)))
    if dyadic:
        w = rng.integers(-128, 128, (K, K, c_in, c_out)) / 256.0
    else:
        w = rng.normal(size=(K, K, c_in, c_out))
    return fmt, occ, w.astype(np.float32)


def _b1_kw(fmt, hw, depth, K=3):
    return dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw)


@pytest.mark.parametrize("hw,c_in,c_out,depth", B1_SHAPES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_fused_spike_accum_plain_matches_reference(hw, c_in, c_out, depth,
                                                   dyadic):
    """Plain B1 == JAX fused_spike_accum_xla == JAX and torch scatter
    oracles: exactly on dyadic weights, to 1e-4 on Gaussian ones (the
    summation order differs). Covers depth < P drops and the uncompressed
    hw=10 format."""
    fmt, occ, w = _occ_weights(hw, c_in, c_out, depth, dyadic)
    kw = _b1_kw(fmt, hw, depth)
    got = tops.fused_spike_accum(torch.from_numpy(occ), torch.from_numpy(w),
                                 bits=fmt.bits_coord, **kw)[0].numpy()
    want = {
        "xla": np.asarray(jops.fused_spike_accum(
            jnp.asarray(occ), jnp.asarray(w), impl="xla",
            bits=fmt.bits_coord, invalid=fmt.invalid_word, **kw)),
        "jax_ref": np.asarray(jref.fused_spike_accum_ref(
            jnp.asarray(occ), jnp.asarray(w), **kw)),
        "torch_ref": tref.fused_spike_accum_ref(
            torch.from_numpy(occ), torch.from_numpy(w), **kw).numpy(),
    }
    for name, ref in want.items():
        if dyadic:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("K", [1, 3, 5])
@pytest.mark.parametrize("hw,c_in,c_out,depth", B1_SHAPES)
def test_ordered_oracle_matches_reference(hw, c_in, c_out, depth, K):
    """The (c, phase)-ordered oracle — the sequence of adds B1 and B3
    perform — equals both scatter oracles bit for bit on dyadic weights and
    the JAX fused_spike_accum_xla within 1e-5 on Gaussian ones, depth < P
    drops and K in {1, 3, 5} included."""
    fmt, occ, w = _occ_weights(hw, c_in, c_out, depth, dyadic=True, K=K)
    kw = _b1_kw(fmt, hw, depth, K)
    got = tref.fused_spike_accum_ordered_ref(
        torch.from_numpy(occ), torch.from_numpy(w), **kw).numpy()
    np.testing.assert_array_equal(got, tref.fused_spike_accum_ref(
        torch.from_numpy(occ), torch.from_numpy(w), **kw).numpy())
    np.testing.assert_array_equal(got, np.asarray(jref.fused_spike_accum_ref(
        jnp.asarray(occ), jnp.asarray(w), **kw)))
    _, _, w_g = _occ_weights(hw, c_in, c_out, depth, dyadic=False, K=K)
    got = tref.fused_spike_accum_ordered_ref(
        torch.from_numpy(occ), torch.from_numpy(w_g), **kw).numpy()
    want = np.asarray(jops.fused_spike_accum(
        jnp.asarray(occ), jnp.asarray(w_g), impl="xla", bits=fmt.bits_coord,
        invalid=fmt.invalid_word, **kw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ordered_oracle_adds_in_channel_then_phase_order():
    """One output, three events: c=0 phase 0, c=0 phase 4, c=1 phase 0.
    Weights 1, 2^-24 and 2^-24 give 1 + 2^-24 + 2^-24 = 1 in fp32 when
    added in that order, but 1 + 2^-23 in any order that sums the small
    ones first — so the result pins the order."""
    occ = torch.zeros((1, 2, 9, 1), dtype=torch.int32)
    occ[0, 0, 0] = occ[0, 0, 4] = occ[0, 1, 0] = 1
    w = torch.zeros((3, 3, 2, 1))
    # output (1, 1) sees the phase-0 event (0, 0) through offset (0, 0)
    # and the phase-4 event (1, 1) through offset (1, 1)
    w[0, 0, 0] = 1.0
    w[1, 1, 0] = 2.0 ** -24
    w[0, 0, 1] = 2.0 ** -24
    out = tref.fused_spike_accum_ordered_ref(occ, w, K=3, n_win=1, depth=4,
                                             H=3, W=3)
    assert out[0, 1, 1, 0].item() == 1.0


def test_fused_spike_accum_drops_follow_segment_keep():
    """With depth 1 only the first event of each queue survives: the charge
    equals a conv of the segment_keep-masked map, and differs from the
    undropped one."""
    fmt, occ, w = _occ_weights(12, 2, 4, 1, dyadic=True)
    kw = _b1_kw(fmt, 12, 1)
    t_occ, t_w = torch.from_numpy(occ), torch.from_numpy(w)
    dropped = tsp.fused_spike_accum_plain(t_occ, t_w, **kw)[0]
    full = tsp.fused_spike_accum_plain(t_occ, t_w, **{**kw, "depth": 64})[0]
    first_only = tref.fused_spike_accum_ref(t_occ, t_w, **kw)
    assert torch.equal(dropped, first_only)
    assert not torch.equal(dropped, full)


STATS_CASES = {  # name: (hw, c_in, c_out, T, depth, spike density, samples)
    # CIFAR-10's 32x32 stage: depth 64 < P = 121, so dense queues drop
    "cifar10_32x32": (32, 32, 32, 4, 64, 0.6, 2),
    # SVHN's C_in = 1 stage: every queue past its depth
    "svhn_c_in_1": (32, 1, 32, 4, 64, 0.85, 2),
    # a pooled 10x10 stage: depth >= P = 16, nothing can drop
    "pooled_10x10": (10, 32, 64, 4, 64, 0.5, 2),
    "depth_1": (12, 3, 16, 4, 1, 0.3, 3),
    # sample 0 all empty, 1 all fired, 2 empty and fired steps in turn
    "empty_and_fired_rows": (9, 2, 8, 4, 16, None, 4),
    "t3_uncompressed_hw10": (10, 2, 8, 3, 5, 0.4, 3),
    "t1": (9, 2, 8, 1, 4, 0.4, 3),
}


def _stats_raster(hw, c_in, T, density, B, seed):
    rng = np.random.default_rng(seed)
    if density is None:
        r = (rng.random((B, T, hw, hw, c_in)) < 0.4).astype(np.float32)
        r[0], r[1] = 0.0, 1.0
        r[2, 0::2], r[2, 1::2] = 0.0, 1.0
    else:
        r = (rng.random((B, T, hw, hw, c_in)) < density).astype(np.float32)
    return torch.from_numpy(r)


def _reference_queue_stats(fmt, hw, depth, c_out, raster):
    """The JAX reference engine's queue statistics of a (B, T, H, W, C)
    raster (``repro.core.engine``'s ``queue_pallas`` stage)."""
    occ = jaeq.phase_occupancy(fmt, jnp.asarray(raster.numpy()))
    keep = jaeq.segment_keep(occ, depth)
    tot = (occ > 0).sum(-1)
    capped = jnp.minimum(tot, depth)
    ev = capped.sum((1, 2, 3)).astype(jnp.int32)
    ovf = (tot - capped).sum((1, 2, 3)).astype(jnp.int32)
    ops = ((keep * jaeq.span_map(fmt, hw)[None, None, None]).sum(
        (1, 2, 3, 4)) * c_out).astype(jnp.int32)
    return [torch.from_numpy(np.array(x)) for x in (ev, ovf, ops)]


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_fused_stats_plain_equal_queue_stats(case):
    """B1's statistics on the CPU (``steps`` = T rows a sample): (ev, ovf,
    ops) equal the JAX reference's and the engine's ``_queue_stats`` bit
    for bit, the charge is the plain B1's, and changing one sample's rows
    leaves every other sample's statistics as they were."""
    from types import SimpleNamespace

    from repro_torch.core import aeq as taeq
    from repro_torch.core import encoding as tenc
    from repro_torch.core import engine

    hw, c_in, c_out, T, depth, density, B = STATS_CASES[case]
    fmt = tenc.make_format(hw, 3)
    jfmt = jenc.make_format(hw, 3)
    cp = SimpleNamespace(fmt=fmt, in_hw=hw, out_c=c_out)
    w = torch.from_numpy(np.random.default_rng(hw).integers(
        -128, 128, (3, 3, c_in, c_out)).astype(np.float32) / 256.0)
    kw = dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)

    def stats(raster):
        occ = taeq.phase_occupancy(fmt, raster)
        flat = occ.reshape(B * T, *occ.shape[2:])
        got = tops.fused_spike_accum(flat, w, bits=fmt.bits_coord, steps=T,
                                     **kw)
        assert torch.equal(got[0],
                           tsp.fused_spike_accum_plain(flat, w, **kw)[0])
        _, _, _, ev, ovf, ops = engine._queue_stats(cp, depth, raster)
        reference = _reference_queue_stats(jfmt, hw, depth, c_out, raster)
        for g, want, ref in zip(got[1:], (ev, ovf, ops), reference):
            assert g.dtype == torch.int32 and g.shape == (B,)
            assert torch.equal(g, want) and torch.equal(g, ref)
        return torch.stack(got[1:], 1)

    raster = _stats_raster(hw, c_in, T, density, B, seed=len(case))
    before = stats(raster)
    if case == "svhn_c_in_1":
        assert bool((before[:, 1] > 0).all())     # every sample drops
    if case == "pooled_10x10":
        assert bool((before[:, 1] == 0).all())
    changed = raster.clone()
    changed[0] = _stats_raster(hw, c_in, T, 0.5, 1, seed=99)[0]
    after = stats(changed)
    assert not torch.equal(after[0], before[0])
    assert torch.equal(after[1:], before[1:])


def test_fused_stats_counts_its_dispatch_and_is_b1s_alone():
    """A B1 dispatch counts ``kernels.dispatch.fused:xla`` alone on the CPU
    and returns the statistics; the sparse realization and the oracles
    return the charge alone, and the steps must divide the rows."""
    from repro_torch import obs

    fmt, occ, w = _occ_weights(9, 2, 8, 4, dyadic=True, T=4)
    t_occ, t_w = torch.from_numpy(occ), torch.from_numpy(w)
    kw = dict(bits=fmt.bits_coord, **_b1_kw(fmt, 9, 4))
    obs.enable()
    try:
        got = tops.fused_spike_accum(t_occ, t_w, steps=2, **kw)
        counters = obs.metrics_snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert counters == {"kernels.dispatch.fused:xla": 1}
    assert len(got) == 4 and all(g.shape == (t_occ.shape[0] // 2,)
                                 for g in got[1:])
    for extra in ({"impl": "sparse", "e_cap": 64}, {"impl": "ref"}):
        assert isinstance(tops.fused_spike_accum(t_occ, t_w, **extra, **kw),
                          torch.Tensor)
    with pytest.raises(ValueError, match="samples of 3 steps"):
        tops.fused_spike_accum(t_occ, t_w, steps=3, **kw)


def test_queue_pallas_takes_its_stats_from_b1():
    """The ``queue_pallas`` backend no longer runs ``_queue_stats``: with
    that chain made to fail, its stats still equal ``queue_ref``'s, which
    keeps it."""
    from unittest import mock

    from _torch_nets import dyadic_net
    from repro_torch.core import engine

    params, th = dyadic_net("6C3-P2-4C3-8", 10, 1)
    cfg = engine.SNNConfig(spec="6C3-P2-4C3-8", input_hw=10, input_c=1, T=3,
                           depth=2)
    imgs = np.random.default_rng(3).random((3, 10, 10, 1)).astype(np.float32)
    _, want = engine.infer_batch(params, th, cfg, imgs, backend="queue_ref",
                                 device="cpu")
    with mock.patch.object(engine, "_queue_stats",
                           side_effect=AssertionError("on the path")):
        _, got = engine.infer_batch(params, th, cfg, imgs,
                                    backend="queue_pallas", device="cpu")
    for g, x in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(x))
    assert int(np.asarray(want.overflow).sum()) > 0


@pytest.mark.parametrize("m,k,n", B2_SHAPES)
def test_quant_matmul_plain_bit_exact(m, k, n):
    """Plain B2 == JAX Pallas quant_matmul (interpret) == both oracles,
    bit for bit, including ragged M/K/N."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    sa, sb = np.float32(0.013), np.float32(0.021)
    got = tops.quant_matmul(torch.from_numpy(a), torch.from_numpy(b),
                            torch.tensor(sa), torch.tensor(sb)).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pallas = np.asarray(jqm.quant_matmul(ja, jb, jnp.float32(sa),
                                         jnp.float32(sb), block_m=64,
                                         block_n=64, block_k=64,
                                         interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, np.asarray(jref.quant_matmul_ref(ja, jb, jnp.float32(sa),
                                              jnp.float32(sb))))
    np.testing.assert_array_equal(
        got, tref.quant_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.tensor(sa), torch.tensor(sb)).numpy())


def test_cpu_dispatch_never_counts_launches():
    tops.reset_launch_counts()
    fmt, occ, w = _occ_weights(9, 1, 8, 16, dyadic=True)
    tops.fused_spike_accum(torch.from_numpy(occ), torch.from_numpy(w),
                           bits=fmt.bits_coord, **_b1_kw(fmt, 9, 16))
    tops.fused_spike_accum(torch.from_numpy(occ), torch.from_numpy(w),
                           bits=fmt.bits_coord, impl="sparse", e_cap=64,
                           weight_bits=8, **_b1_kw(fmt, 9, 16))
    a = torch.ones((4, 8), dtype=torch.int8)
    tops.quant_matmul(a, a.T.contiguous(), torch.tensor(1.0), torch.tensor(1.0))
    assert tops.launch_counts == {"fused_spike_accum": 0, "quant_matmul": 0,
                                  "fused_spike_accum_sparse": 0,
                                  "event_accum": 0, "spike_compact": 0,
                                  "moe_gather": 0}


def test_lib_path_hashes_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header renames every library, so a stale build
    that included the old header is never reused."""
    from repro_torch.kernels import _cuda

    for f in _cuda.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = {n: _cuda._lib_path(n) for n in _cuda.SOURCES}
    header = tmp_path / "spike_accum.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda._lib_path(n) for n in _cuda.SOURCES}
    assert all(before[n] != after[n] for n in _cuda.SOURCES)
    assert _cuda._lib_path("spike_pipeline") == after["spike_pipeline"]


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor (no silent fallback)."""
    fmt, occ, w = _occ_weights(9, 1, 8, 16, dyadic=True)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.fused_spike_accum_cuda(torch.from_numpy(occ), torch.from_numpy(w),
                                   **_b1_kw(fmt, 9, 16))
    a = torch.ones((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_cuda(a, a.T.contiguous(), torch.tensor(1.0),
                              torch.tensor(1.0))


# --- C3: shapes past the card's old limits ----------------------------------

C3_SHAPES = [  # (hw, c_in, c_out, depth, K): K without an unrolled gather
    # (the card's rolled one), and a map past the old staged-bits limit
    (20, 2, 8, 4, 9), (24, 2, 8, 16, 11), (100, 2, 8, 16, 3)]


@pytest.mark.parametrize("hw,c_in,c_out,depth,K", C3_SHAPES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_c3_plain_versions_match_reference(hw, c_in, c_out, depth, K,
                                           dyadic):
    """At K = 9, 11 and at a 100x100 map: plain B1, plain B3 (fp32 and
    w8) and the (c, phase)-ordered oracle against the JAX oracles — the
    quantized path exactly, the fp32 ones exactly on dyadic weights and to
    1e-4 on Gaussian ones (other orders of adds)."""
    from repro_torch.kernels import spike_sparse as tss

    fmt, occ, w = _occ_weights(hw, c_in, c_out, depth, dyadic, T=2, K=K)
    kw = _b1_kw(fmt, hw, depth, K)
    jocc, jw = jnp.asarray(occ), jnp.asarray(w)
    occ_t, w_t = torch.from_numpy(occ), torch.from_numpy(w)
    want = np.asarray(jref.fused_spike_accum_ref(jocc, jw, **kw))
    e_cap = tss.event_bucket(
        int(tss.kept_event_count(occ_t, depth=depth)),
        tss.max_kept_events(occ.shape, depth))
    got = {
        "b1 plain": tops.fused_spike_accum(occ_t, w_t, bits=fmt.bits_coord,
                                           **kw)[0],
        "b3 plain": tops.fused_spike_accum(occ_t, w_t, bits=fmt.bits_coord,
                                           impl="sparse", e_cap=e_cap, **kw),
        "ordered": tref.fused_spike_accum_ordered_ref(occ_t, w_t, **kw),
    }
    for name, g in got.items():
        if dyadic:
            np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), want, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
    q = tops.fused_spike_accum(occ_t, w_t, bits=fmt.bits_coord, impl="sparse",
                               e_cap=e_cap, weight_bits=8, **kw)
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        jref.fused_spike_accum_quant_ref(jocc, jw, weight_bits=8, **kw)))


@pytest.mark.parametrize("K", [1, 3, 5, 7])
def test_gather_limit_accepts_512_and_raises_past_what_fits(K):
    """The unrolled gather stages a block's kept bits by window row, so its
    shared memory grows with the map's width: a 512x512 map fits at every
    unrolled K, and the first size that does not raise names its bytes."""
    def n_win(w):
        return -(-w // K)

    tsp.check_gather_fits(K, n_win(512), 512, 512)
    assert tsp.gather_smem(K, n_win(512), 512, 512) <= tsp._SMEM_MAX
    w = 512
    while tsp.gather_smem(K, n_win(w), w, w) <= tsp._SMEM_MAX:
        w += 8
    with pytest.raises(ValueError, match=str(tsp.gather_smem(
            K, n_win(w), w, w)) + " bytes"):
        tsp.check_gather_fits(K, n_win(w), w, w)


def test_gather_limit_rolled_k_and_even_k():
    """Any other odd K runs the rolled gather, which stages nothing; an
    even K is refused."""
    for K in (9, 11, 13, 31):
        tsp.check_gather_fits(K, -(-2048 // K), 2048, 2048)
    with pytest.raises(ValueError, match="odd K"):
        tsp.check_gather_fits(4, 8, 32, 32)


def test_gather_smem_is_the_old_number_for_small_maps():
    """Where a block's cells' window rows (plus halo) cover the whole map,
    the staged words are all NW words of a queue, as before the restaging:
    every map of the paper's nets (W <= 32 at K = 3) stages at most that."""
    for w, K in ((32, 3), (10, 3), (3, 3), (28, 3)):
        nw = -(-(-(-w // K)) ** 2 // 32)
        cells = (-(-w // K)) ** 2
        rows = (8 + cells - 2) // cells + 1
        old = 4 * (2 * 9 * 32 * 32 + 2 * rows * 32 * ((9 * nw) | 1))
        assert tsp.gather_smem(K, -(-w // K), w, w) <= old


def test_b3_int_sums_switch_to_int32_past_2_24():
    """B3's int path sums in fp32 only while K*K*C_in*127 < 2^24 (every
    partial sum an exact fp32 integer); past it the kernel sums in int32."""
    from repro_torch.kernels import spike_sparse as tss

    assert tss.int_sums_fit_fp32(3, 14_678)
    assert not tss.int_sums_fit_fp32(3, 14_679)
    assert not tss.int_sums_fit_fp32(7, 2_720)
