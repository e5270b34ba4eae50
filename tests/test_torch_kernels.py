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


def _occ_weights(hw, c_in, c_out, depth, dyadic, T=3):
    rng = np.random.default_rng(hw * 100 + c_in * 10 + depth)
    raster = (rng.random((T, hw, hw, c_in)) < 0.25).astype(np.float32)
    fmt = jenc.make_format(hw, 3)
    occ = np.array(jaeq.phase_occupancy(fmt, jnp.asarray(raster)))
    if dyadic:
        w = rng.integers(-128, 128, (3, 3, c_in, c_out)) / 256.0
    else:
        w = rng.normal(size=(3, 3, c_in, c_out))
    return fmt, occ, w.astype(np.float32)


def _b1_kw(fmt, hw, depth):
    return dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)


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
                                  "fused_spike_accum_sparse": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor (no silent fallback)."""
    fmt, occ, w = _occ_weights(9, 1, 8, 16, dyadic=True)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.fused_spike_accum_cuda(torch.from_numpy(occ), torch.from_numpy(w),
                                   bits=fmt.bits_coord, **_b1_kw(fmt, 9, 16))
    a = torch.ones((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_cuda(a, a.T.contiguous(), torch.tensor(1.0),
                              torch.tensor(1.0))
