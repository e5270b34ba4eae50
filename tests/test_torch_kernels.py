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
                                 bits=fmt.bits_coord, **kw).numpy()
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
    dropped = tsp.fused_spike_accum_plain(t_occ, t_w, **kw)
    full = tsp.fused_spike_accum_plain(t_occ, t_w, **{**kw, "depth": 64})
    first_only = tref.fused_spike_accum_ref(t_occ, t_w, **kw)
    assert torch.equal(dropped, first_only)
    assert not torch.equal(dropped, full)


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
                                           **kw),
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
