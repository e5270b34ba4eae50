"""The port's word-level queue slice against the JAX package, on the CPU.

Same numpy-seeded inputs on both sides. The JAX side is its pure functions
only: the oracles of ``kernels/ref.py``, the word-level AEQ model
(``aeq.compact_spikes`` / ``aeq_from_raster``), ``snn_layers`` and the
engine's ``queue`` backend and ``infer`` — never the Pallas interpret
paths. On the CPU the port's ``kernels.ops`` runs each kernel's plain
version (B5 ``spike_compact``, B4 ``event_accum``, B6 ``moe_gather``); the
CUDA kernels are held against those on the card by
``tests/test_torch_cuda.py``.

Tolerances: integer outputs (words, counts, overflow, stats) exact. The
plain event accumulate adds in the reference ``event_conv2d``'s order
(offset by offset, events in (c, phase, slot) order) and ``index_add_`` on
the CPU adds in index order, so ``event_conv2d`` is bit-exact on Gaussian
weights too. The conv oracles sum in another order than XLA's conv: 1e-4 on
Gaussian weights, exact on dyadic ones. Engine logits: bit-exact on the
dyadic nets of ``_torch_nets``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro.core import snn_layers as jlayers
from repro.kernels import ref as jref
from repro_torch.core import aeq as taeq
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as tengine
from repro_torch.core import snn_layers as tlayers
from repro_torch.kernels import event_accum as tea
from repro_torch.kernels import moe_gather as tmg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spike_compact as tsc

from _torch_nets import dyadic_net, images
from _torch_queues import repeated_queues

EA_SHAPES = [  # (hw, c_in, c_out, depth): tests/test_kernels.py, + hw=10
    (9, 1, 8, 16), (12, 3, 16, 32), (28, 4, 32, 64), (28, 2, 128, 24),
    (10, 3, 8, 4)]
SC_SHAPES = [(4, 4, 8), (9, 10, 40), (18, 10, 16)]   # (rows, n_win, depth)
MG_SHAPES = [(16, 8, 12), (64, 32, 50), (10, 128, 40)]   # (T, d, S)
STAT_FIELDS = ("events_in", "spikes_out", "add_ops", "overflow",
               "queue_words")
SPEC, HW, C = "6C3-P2-8C3-P3-10", 12, 2     # tests/test_torch_engine.py


def _raster(T, c_in, hw, seed, p_fire=0.15):
    rng = np.random.default_rng(seed)
    return (rng.random((T, c_in, hw, hw)) < p_fire).astype(np.float32)


def _weights(c_in, c_out, dyadic, seed=1):
    rng = np.random.default_rng(seed)
    if dyadic:
        return (rng.integers(-128, 128, (3, 3, c_in, c_out))
                / 256.0).astype(np.float32)
    return rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)


def _queues(hw, c_in, depth, seed, T=2):
    """The same raster's AEQ from both packages (asserted equal)."""
    raster = _raster(T, c_in, hw, seed)
    fj, ft = jenc.make_format(hw, 3), tenc.make_format(hw, 3)
    qj = jaeq.aeq_from_raster(fj, jnp.asarray(raster), depth)
    qt = taeq.aeq_from_raster(ft, torch.from_numpy(raster), depth)
    for a, b in zip(qt, qj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return fj, ft, qj, qt


# --- the oracles ------------------------------------------------------------

@pytest.mark.parametrize("hw,c_in,c_out,depth", EA_SHAPES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_event_accum_ref_matches_reference(hw, c_in, c_out, depth, dyadic):
    fj, ft, qj, qt = _queues(hw, c_in, depth, seed=hw * depth)
    w = _weights(c_in, c_out, dyadic)
    vm = np.random.default_rng(2).normal(size=(hw, hw, c_out))
    vm = (np.round(vm * 16) / 16 if dyadic else vm).astype(np.float32)
    kw = dict(K=3, n_win=fj.n_win, bits=fj.bits_coord)
    want = jref.event_accum_ref(qj.words[0], qj.counts[0], jnp.asarray(w),
                                jnp.asarray(vm), **kw)
    got = tref.event_accum_ref(qt.words[0], qt.counts[0], torch.from_numpy(w),
                               torch.from_numpy(vm), **kw)
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("rows,n_win,depth", SC_SHAPES)
def test_spike_compact_ref_and_plain_match_reference(rows, n_win, depth):
    """The torch oracle and B5's plain version (through ``ops``) equal the
    JAX oracle exactly, words and uncapped counts."""
    fmt = jenc.make_format(n_win * 3, 3)
    occ = (np.random.default_rng(rows).random((rows, n_win * n_win))
           < 0.3).astype(np.int32)
    kw = dict(n_win=n_win, bits=fmt.bits_coord, depth=depth,
              invalid=fmt.invalid_word)
    wj, cj = jref.spike_compact_ref(jnp.asarray(occ), **kw)
    for fn in (tref.spike_compact_ref, tops.spike_compact):
        wt, ct = fn(torch.from_numpy(occ), **kw)
        assert wt.dtype == ct.dtype == torch.int32
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("t,d,s", MG_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_ref_and_plain_match_reference(t, d, s, dtype):
    rng = np.random.default_rng(t + d)
    x = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(-1, t, s).astype(np.int32)
    want = np.asarray(jref.moe_gather_ref(jnp.asarray(x, dtype), jnp.asarray(idx))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for fn in (tref.moe_gather_ref, tops.moe_gather):
        got = fn(xt, torch.from_numpy(idx))
        assert got.dtype == xt.dtype and got.shape == (s, d)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_moe_gather_zero_rows_and_clamp():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = tops.moe_gather(x, torch.tensor([-1, 3, 9, 0], dtype=torch.int32))
    assert torch.equal(got, torch.stack([torch.zeros(3), x[3], x[3], x[0]]))


# --- the word-level AEQ model -------------------------------------------------

@pytest.mark.parametrize("hw,depth", [(9, 2), (12, 5), (10, 3), (28, 64)])
def test_compact_spikes_matches_reference(hw, depth):
    """Per map: words, capped counts and dropped events, in the compressed
    format (9, 28) and the uncompressed fallback (10, 12: n_win = 4)."""
    maps = _raster(3, 1, hw, seed=hw, p_fire=0.4)[:, 0]
    fj, ft = jenc.make_format(hw, 3), tenc.make_format(hw, 3)
    wt, ct, dt = taeq.compact_spikes(ft, torch.from_numpy(maps), depth)
    for i, m in enumerate(maps):
        wj, cj, dj = jaeq.compact_spikes(fj, jnp.asarray(m), depth)
        np.testing.assert_array_equal(wt[i].numpy(), np.asarray(wj))
        np.testing.assert_array_equal(ct[i].numpy(), np.asarray(cj))
        assert int(dt[i]) == int(dj)
    assert int(dt.sum()) > 0 or depth == 64


def test_phase_split_and_decode_match_reference():
    fj, ft = jenc.make_format(12, 3), tenc.make_format(12, 3)
    m = _raster(1, 1, 12, seed=4, p_fire=0.3)[0, 0]
    np.testing.assert_array_equal(
        taeq._phase_split(ft, torch.from_numpy(m)).numpy(),
        np.asarray(jaeq._phase_split(fj, jnp.asarray(m))))
    for hw in (9, 12):
        fj, ft = jenc.make_format(hw, 3), tenc.make_format(hw, 3)
        words, _, _ = jaeq.compact_spikes(
            fj, jnp.asarray(_raster(1, 1, hw, seed=hw)[0, 0]), 8)
        got = taeq.decode_positions(ft, torch.from_numpy(np.array(words)))
        for a, b in zip(got, jaeq.decode_positions(fj, words)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("hw,c_in,depth", [(9, 2, 3), (12, 3, 16), (10, 2, 2)])
def test_aeq_builders_match_reference(hw, c_in, depth):
    """aeq_init, aeq_set_segment, aeq_from_raster(_batch) and
    aeq_total_events, field by field."""
    fj, ft = jenc.make_format(hw, 3), tenc.make_format(hw, 3)
    raster = np.stack([_raster(3, c_in, hw, seed=s, p_fire=0.3)
                       for s in (1, 2)])                    # (B, T, C, H, W)
    qb = taeq.aeq_from_raster_batch(ft, torch.from_numpy(raster), depth)
    jb = jaeq.aeq_from_raster_batch(fj, jnp.asarray(raster), depth)
    for a, b in zip(qb, jb):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(qb.overflow.sum()) > 0 or depth == 16
    q = taeq.aeq_init(ft, 3, c_in, depth)
    j = jaeq.aeq_init(fj, 3, c_in, depth)
    q = taeq.aeq_set_segment(q, ft, 1, torch.from_numpy(raster[0, 1]))
    j = jaeq.aeq_set_segment(j, fj, 1, jnp.asarray(raster[0, 1]))
    for a, b in zip(q, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q1 = taeq.aeq_from_raster(ft, torch.from_numpy(raster[1]), depth)
    assert int(taeq.aeq_total_events(q1)) == int(
        jaeq.aeq_total_events(jaeq.aeq_from_raster(
            fj, jnp.asarray(raster[1]), depth)))
    assert int(q1.overflow) == int(qb.overflow[1])


# --- the event layers -------------------------------------------------------

@pytest.mark.parametrize("hw,c_in,c_out,depth", EA_SHAPES)
def test_event_conv2d_bit_exact_on_gaussian_weights(hw, c_in, c_out, depth):
    """Membrane and n_ops equal the reference's at every step, Gaussian
    weights and membrane included (the plain accumulate keeps its order)."""
    fj, ft, qj, qt = _queues(hw, c_in, depth, seed=hw * depth)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)
    vm = rng.normal(size=(hw, hw, c_out)).astype(np.float32)
    for t in range(2):
        vj, nj = jlayers.event_conv2d(jnp.asarray(vm), jnp.asarray(w), qj, fj,
                                      t)
        vt, nt = tlayers.event_conv2d(torch.from_numpy(vm),
                                      torch.from_numpy(w), qt, ft, t)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert nt.dtype == torch.int32 and int(nt) == int(nj)


def test_event_conv2d_batched_rows_equal_per_sample():
    """A (B, T, C, K2, D) queue and a (B, H, W, C_out) membrane: each row
    equals the per-sample call (one B4 launch covers all rows)."""
    ft = tenc.make_format(12, 3)
    raster = torch.from_numpy(np.stack([_raster(2, 3, 12, seed=s)
                                        for s in (5, 6, 7)]))
    q = taeq.aeq_from_raster_batch(ft, raster, 8)
    w = torch.from_numpy(_weights(3, 16, dyadic=False))
    vm = torch.from_numpy(np.random.default_rng(8).normal(
        size=(3, 12, 12, 16)).astype(np.float32))
    vb, nb = tlayers.event_conv2d(vm, w, q, ft, 1)
    assert nb.shape == (3,)
    for i in range(3):
        v1, n1 = tlayers.event_conv2d(
            vm[i], w, taeq.AEQ(q.words[i], q.counts[i], q.overflow[i]), ft, 1)
        assert torch.equal(vb[i], v1) and int(nb[i]) == int(n1)


@pytest.mark.parametrize("hw,c_in,c_out,depth", EA_SHAPES[:3])
def test_event_conv2d_equals_dense_conv_oracle(hw, c_in, c_out, depth):
    """The identity the design rests on, and the port's oracle against the
    reference's: exact on dyadic weights with no drops (depth >= P)."""
    rng = np.random.default_rng(hw)
    m = (rng.random((c_in, hw, hw)) < 0.2).astype(np.float32)
    w = _weights(c_in, c_out, dyadic=True)
    ft = tenc.make_format(hw, 3)
    q = taeq.aeq_from_raster(ft, torch.from_numpy(m[None]), ft.n_win ** 2)
    v, _ = tlayers.event_conv2d(torch.zeros((hw, hw, c_out)),
                                torch.from_numpy(w), q, ft, 0)
    oracle = tlayers.dense_conv_oracle(torch.from_numpy(m),
                                       torch.from_numpy(w))
    assert torch.equal(v, oracle)
    np.testing.assert_array_equal(
        oracle.numpy(),
        np.asarray(jlayers.dense_conv_oracle(jnp.asarray(m), jnp.asarray(w))))


def test_event_dense_and_spike_maxpool_match_reference():
    rng = np.random.default_rng(11)
    spikes = (rng.random(40) < 0.3).astype(np.float32)
    w = (rng.integers(-64, 64, (40, 6)) / 64.0).astype(np.float32)
    vm = np.zeros(6, np.float32)
    vj, nj = jlayers.event_dense(jnp.asarray(vm), jnp.asarray(w),
                                 jnp.asarray(spikes))
    vt, nt = tlayers.event_dense(torch.from_numpy(vm), torch.from_numpy(w),
                                 torch.from_numpy(spikes))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(nt) == int(nj)
    sp = (rng.random((4, 10, 10)) < 0.3).astype(np.float32)
    latch = rng.random((4, 3, 3)) < 0.5
    for once in (True, False):
        got = tlayers.spike_maxpool(torch.from_numpy(sp), 3,
                                    torch.from_numpy(latch), latch_once=once)
        want = jlayers.spike_maxpool(jnp.asarray(sp), 3, jnp.asarray(latch),
                                     latch_once=once)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("hw,c_in,c_out,depth", EA_SHAPES[:3])
def test_event_accum_plain_matches_oracle_batched(hw, c_in, c_out, depth):
    """B4's plain version over a leading row axis: each row equals the
    torch oracle (1e-4: the oracle convolves) and the rows are
    independent."""
    ft = tenc.make_format(hw, 3)
    raster = torch.from_numpy(np.stack([_raster(1, c_in, hw, seed=s)[0]
                                        for s in (1, 2)]))   # (N, C, H, W)
    q = taeq.aeq_from_raster(ft, raster, depth)   # rows as the T axis
    w = torch.from_numpy(_weights(c_in, c_out, dyadic=False))
    vm = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, hw, hw, c_out)).astype(np.float32))
    kw = dict(K=3, n_win=ft.n_win, bits=ft.bits_coord)
    got = tea.event_accum_plain(q.words, q.counts, w, vm, **kw)
    for n in range(2):
        want = tref.event_accum_ref(q.words[n], q.counts[n], w, vm[n], **kw)
        torch.testing.assert_close(got[n], want, atol=1e-4, rtol=1e-4)
        one = tops.event_accum(q.words[n], q.counts[n], w, vm[n], **kw)
        assert torch.equal(one, got[n])


def test_event_accum_plain_bf16_matches_reference():
    """B4's plain version in bf16 against the JAX oracle in fp32, with the
    inputs and the tolerance of tests/test_kernels.py's bf16 event_accum
    test (atol 0.1: each bf16 add rounds to 8 significant bits)."""
    fmt = jenc.make_format(12, 3)
    rng = np.random.default_rng(0)
    raster = (rng.random((1, 2, 12, 12)) < 0.2).astype(np.float32)
    q = jaeq.aeq_from_raster(fmt, jnp.asarray(raster), 32)
    w = rng.normal(size=(3, 3, 2, 8)).astype(np.float32)
    w_bf16 = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    kw = dict(K=3, n_win=fmt.n_win, bits=fmt.bits_coord)
    want = np.asarray(jref.event_accum_ref(
        q.words[0], q.counts[0], jnp.asarray(w_bf16),
        jnp.zeros((12, 12, 8), jnp.float32), **kw))
    got = tops.event_accum(
        torch.from_numpy(np.array(q.words[0])),
        torch.from_numpy(np.array(q.counts[0])),
        torch.from_numpy(w_bf16).bfloat16(),
        torch.zeros((12, 12, 8), dtype=torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.1)


def test_event_accum_plain_bf16_rounds_every_add():
    """Four channels each add 1 to a membrane of 256: in bf16 every add
    rounds 257 back to 256 (a tie, to even), as the TPU kernel's `cur + w`
    does; a sum carried in a wider type would give 260."""
    ft = tenc.make_format(12, 3)
    words = torch.full((1, 4, 9, 1), ft.invalid_word, dtype=torch.int32)
    words[0, :, 0, 0] = 0                       # window (0, 0), phase 0
    counts = torch.zeros((1, 4, 9), dtype=torch.int32)
    counts[0, :, 0] = 1
    vm = torch.full((1, 12, 12, 2), 256.0, dtype=torch.bfloat16)
    w = torch.ones((3, 3, 4, 2), dtype=torch.bfloat16)
    out = tea.event_accum_plain(words, counts, w, vm, K=3, n_win=ft.n_win,
                                bits=ft.bits_coord)
    assert torch.equal(out, vm)
    wide = tea.event_accum_plain(words, counts, w.float(), vm.float(), K=3,
                                 n_win=ft.n_win, bits=ft.bits_coord)
    assert wide[0, 0, 0, 0].item() == 260.0


def test_event_accum_count_kills_uncompressed_invalid_words():
    """hw=10 has n_win = 4 and no spare pattern: the invalid word decodes to
    window row 0, so only the count may kill a slot (as the TPU kernel)."""
    ft = tenc.make_format(10, 3)
    assert not ft.compressed
    words = torch.full((1, 1, 9, 4), ft.invalid_word, dtype=torch.int32)
    counts = torch.zeros((1, 1, 9), dtype=torch.int32)
    vm = torch.zeros((1, 10, 10, 2))
    w = torch.ones((3, 3, 1, 2))
    out = tops.event_accum(words, counts, w, vm, K=3, n_win=4,
                           bits=ft.bits_coord)
    assert torch.equal(out, vm)


def _packed(kept):
    """(..., P) bool -> (..., ceil(P / 32)) int32 words, bit p % 32 of word
    p // 32 set <=> kept[..., p]: numpy's little-endian bit packing."""
    kept = np.asarray(kept, dtype=bool)
    P = kept.shape[-1]
    pad = -(-P // 32) * 32 - P
    kept = np.concatenate(
        [kept, np.zeros((*kept.shape[:-1], pad), dtype=bool)], axis=-1)
    packed = np.packbits(kept, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


@pytest.mark.parametrize("hw,K,c_in,depth", [
    (9, 3, 2, 16), (9, 3, 2, 2), (10, 3, 3, 16), (10, 3, 3, 3),
    (32, 3, 2, 64), (32, 3, 2, 5), (3, 3, 4, 64), (20, 5, 2, 8),
    (14, 7, 2, 3), (9, 1, 2, 40)])
def test_event_bits_plain_equals_packed_segment_keep(hw, K, c_in, depth):
    """B4's decode (plain version) turns the queues that compact_spikes (B5)
    builds from an occupancy back into the kept bits of segment_keep on
    that occupancy, packed as B1's encode pass packs them: in the
    compressed and the uncompressed (n_win = 4) format, with depth < P
    (dropped events) and >= P, and K in {1, 3, 5, 7}."""
    ft = tenc.make_format(hw, K)
    assert ft.compressed == (ft.n_win not in (2, 4))   # 10, 20, 14 fall back
    raster = torch.from_numpy(_raster(3, c_in, hw, seed=hw + depth + K,
                                      p_fire=0.4))      # (rows, C, H, W)
    q = taeq.aeq_from_raster(ft, raster, depth)
    got = tea.event_bits_plain(q.words, q.counts, n_win=ft.n_win,
                               bits=ft.bits_coord)
    occ = taeq.phase_occupancy(ft, raster.permute(0, 2, 3, 1))
    want = _packed(taeq.segment_keep(occ, depth).numpy())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(q.overflow) > 0 or depth >= 8   # the small depths drop


def test_event_bits_plain_count_kills_uncompressed_invalid_words():
    """hw=10: the invalid word names window position (0, 0); a slot past
    its queue's count sets no bit, one below it does."""
    ft = tenc.make_format(10, 3)
    words = torch.full((1, 1, 9, 4), ft.invalid_word, dtype=torch.int32)
    counts = torch.zeros((1, 1, 9), dtype=torch.int32)
    kw = dict(n_win=ft.n_win, bits=ft.bits_coord)
    assert not tea.event_bits_plain(words, counts, **kw).any()
    counts[0, 0, 2] = 1
    bits = tea.event_bits_plain(words, counts, **kw)
    assert bits[0, 0, 2, 0] == 1 and int(bits.count_nonzero()) == 1


@pytest.mark.parametrize("hw,c_in,c_out,depth", EA_SHAPES)
@pytest.mark.parametrize("dyadic", [False, True])
def test_ordered_oracle_from_membrane_equals_event_accum(hw, c_in, c_out,
                                                         depth, dyadic):
    """The (c, phase)-ordered oracle started from the membrane (``init``,
    B4's order of adds) on a step's occupancy equals B4's plain version and
    the JAX ``event_accum_ref`` on that step's queues: bit for bit on dyadic
    weights, within 1e-4 on Gaussian ones (three orders of adds)."""
    fj, ft, qj, qt = _queues(hw, c_in, depth, seed=hw * depth + 7)
    w = _weights(c_in, c_out, dyadic, seed=3)
    vm = np.random.default_rng(4).normal(size=(2, hw, hw, c_out))
    vm = (np.round(vm * 16) / 16 if dyadic else vm).astype(np.float32)
    raster = _raster(2, c_in, hw, seed=hw * depth + 7)          # _queues'
    occ = taeq.phase_occupancy(ft, torch.from_numpy(raster).permute(0, 2, 3,
                                                                    1))
    kw = dict(K=3, n_win=ft.n_win, bits=ft.bits_coord)
    got = tref.fused_spike_accum_ordered_ref(
        occ, torch.from_numpy(w), K=3, n_win=ft.n_win, depth=depth, H=hw,
        W=hw, init=torch.from_numpy(vm))
    plain = tea.event_accum_plain(qt.words, qt.counts, torch.from_numpy(w),
                                  torch.from_numpy(vm), **kw)
    want = np.stack([np.asarray(jref.event_accum_ref(
        qj.words[t], qj.counts[t], jnp.asarray(w), jnp.asarray(vm[t]), **kw))
        for t in range(2)])
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ordered_oracle_without_init_starts_from_zero(dtype):
    """``init=None`` (every earlier caller) is the sum from a zero membrane,
    bit for bit, and ``init`` is not modified."""
    ft = tenc.make_format(12, 3)
    raster = torch.from_numpy(_raster(2, 3, 12, seed=5, p_fire=0.3))
    occ = taeq.phase_occupancy(ft, raster.permute(0, 2, 3, 1))
    w = torch.from_numpy(_weights(3, 8, dyadic=False)).to(dtype)
    kw = dict(K=3, n_win=ft.n_win, depth=6, H=12, W=12)
    zero = torch.zeros((2, 12, 12, 8), dtype=dtype)
    base = tref.fused_spike_accum_ordered_ref(occ, w, **kw)
    assert base.dtype == dtype
    assert torch.equal(base, tref.fused_spike_accum_ordered_ref(
        occ, w, init=zero, **kw))
    assert not zero.any()


# --- words the engine never writes: off the grid, or repeated ---------------
#
# fp32 tolerance 1e-5 on Gaussian weights, relative to the output's sum of
# magnitudes |v| + sum |w| over its adds: the JAX oracle convolves (XLA's
# order of adds), the port's plain version and ordered oracle add event by
# event, and a K = 7 output can cancel hundreds of terms. Dyadic weights
# make every sum exact, so those are held bit for bit.

# (hw, K, compressed): n_win not a power of two, so a window coordinate can
# name a column past the grid (K = 3, W = 9: n_win 3, bits 2), in the
# compressed format and with the original encoding's status bits forced
OFF_GRID_FORMATS = [(9, 3, True), (9, 3, False), (7, 1, True), (15, 5, True),
                    (21, 7, True)]
# (hw, K) per K in {1, 3, 5, 7}: the compressed format (n_win 7 or 3) and
# the uncompressed fallback (n_win 4), whose invalid word decodes to (0, 0)
REPEAT_FORMATS = [(7, 1), (4, 1), (9, 3), (12, 3), (15, 5), (20, 5),
                  (21, 7), (28, 7)]


def _jax_event_accum(words, counts, w, vm, **kw):
    """The JAX oracle row by row, as numpy."""
    return np.stack([np.asarray(jref.event_accum_ref(
        jnp.asarray(words[n].numpy()), jnp.asarray(counts[n].numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(vm[n].numpy()), **kw))
        for n in range(words.shape[0])])


def _assert_held(got, want, dyadic, words, counts, w, vm, **kw):
    if dyadic:
        np.testing.assert_array_equal(got, want)
        return
    mag = tea.event_accum_plain(words, counts, w.abs(), vm.abs(), **kw)
    err = np.abs(got - want)
    assert (err <= 1e-5 * (1 + mag.reshape(want.shape).numpy())).all(), \
        float(err.max())


def _membrane_and_weights(rng, N, hw, K, c_in, c_out, dyadic):
    if dyadic:
        w = rng.integers(-128, 128, (K, K, c_in, c_out)) / 256.0
        vm = np.round(rng.normal(size=(N, hw, hw, c_out)) * 16) / 16
    else:
        w = rng.normal(size=(K, K, c_in, c_out))
        vm = rng.normal(size=(N, hw, hw, c_out))
    return (torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(vm.astype(np.float32)))


@pytest.mark.parametrize("hw,K,compressed", OFF_GRID_FORMATS)
@pytest.mark.parametrize("dyadic", [False, True])
def test_off_grid_words_match_reference(hw, K, compressed, dyadic):
    """Live words with j_c >= n_win or i_c >= n_win beside grid words and
    the format's invalid words: B4's plain version, the port's oracle and
    ``ops.event_accum`` (CPU) add what the JAX oracle adds (its scatter
    drops the out-of-range column), and nothing raises."""
    fmt = tenc.make_format(hw, K, compressed=compressed)
    assert fmt.compressed == compressed and fmt.n_win < 1 << fmt.bits_coord
    N, c_in, c_out, D = 2, 3, 8, 12
    rng = np.random.default_rng(hw + K + compressed)
    coords = rng.integers(0, 1 << fmt.bits_coord, (N, c_in, K * K, D, 2))
    words = (coords[..., 0] << fmt.bits_coord) | coords[..., 1]
    counts = rng.integers(0, D + 1, (N, c_in, K * K))
    live = np.arange(D) < counts[..., None]
    words = np.where(live | (rng.random(words.shape) < 0.5), words,
                     fmt.invalid_word)
    off = live & (coords[..., 1] >= fmt.n_win) & (coords[..., 0] < fmt.n_win)
    assert off.any()                    # the repaired case is exercised
    words = torch.from_numpy(words.astype(np.int32))
    counts = torch.from_numpy(counts.astype(np.int32))
    w, vm = _membrane_and_weights(rng, N, hw, K, c_in, c_out, dyadic)
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    want = _jax_event_accum(words, counts, w, vm, **kw)
    held = dict(dyadic=dyadic, words=words, counts=counts, w=w, vm=vm, **kw)
    _assert_held(tea.event_accum_plain(words, counts, w, vm, **kw).numpy(),
                 want, **held)
    _assert_held(tops.event_accum(words, counts, w, vm, **kw).numpy(), want,
                 **held)
    got = torch.stack([tref.event_accum_ref(words[n], counts[n], w, vm[n],
                                            **kw) for n in range(N)])
    _assert_held(got.numpy(), want, **held)


def test_off_grid_word_adds_nothing():
    """K = 3, W = 9 (n_win 3, bits 2): one live word (1, 3) on unit weights
    adds nothing in any realization, as in the JAX oracle."""
    fmt = tenc.make_format(9, 3)
    words = torch.tensor([[[[(1 << 2) | 3]] + [[fmt.invalid_word]] * 8]],
                         dtype=torch.int32)          # (1, 1, 9, 1)
    counts = torch.zeros((1, 1, 9), dtype=torch.int32)
    counts[0, 0, 0] = 1
    w, vm = torch.ones((3, 3, 1, 2)), torch.zeros((1, 9, 9, 2))
    kw = dict(K=3, n_win=3, bits=2)
    assert not _jax_event_accum(words, counts, w, vm, **kw).any()
    assert not tea.event_accum_plain(words, counts, w, vm, **kw).any()
    assert not tref.event_accum_ref(words[0], counts[0], w, vm[0], **kw).any()
    assert not tea.event_mult_plain(words, counts, n_win=3, bits=2).any()


@pytest.mark.parametrize("hw,K", REPEAT_FORMATS)
@pytest.mark.parametrize("dyadic", [False, True])
def test_repeated_words_mult_and_ordered_gather_match_reference(hw, K,
                                                                 dyadic):
    """B4's model of repeated live words: the decode's multiplicities
    (``event_mult_plain``) followed by the (c, phase)-ordered gather that
    adds a position's weight once per occurrence equals the JAX oracle,
    in both AE formats and K in {1, 3, 5, 7}; so does the plain version."""
    fmt = tenc.make_format(hw, K)
    assert fmt.compressed == (fmt.n_win != 4)
    N, c_in, c_out, D = 2, 3, 8, 16
    words, counts = repeated_queues(fmt, N, c_in, D, seed=hw + K)
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    mult = tea.event_mult_plain(words, counts, n_win=fmt.n_win,
                                bits=fmt.bits_coord)
    assert 2 <= int(mult.max()) <= 4 and int(mult.sum()) == int(counts.sum())
    assert torch.equal(tea.event_bits_plain(words, counts, n_win=fmt.n_win,
                                            bits=fmt.bits_coord),
                       tea.pack_bits(mult > 0))
    rng = np.random.default_rng(hw * K)
    w, vm = _membrane_and_weights(rng, N, hw, K, c_in, c_out, dyadic)
    want = _jax_event_accum(words, counts, w, vm, **kw)
    held = dict(dyadic=dyadic, words=words, counts=counts, w=w, vm=vm, **kw)
    got = tref.fused_spike_accum_ordered_ref(
        mult, w, K=K, n_win=fmt.n_win, depth=fmt.n_win ** 2, H=hw, W=hw,
        init=vm, multiplicity=True)
    _assert_held(got.numpy(), want, **held)
    _assert_held(tea.event_accum_plain(words, counts, w, vm, **kw).numpy(),
                 want, **held)


@pytest.mark.parametrize("hw,K", REPEAT_FORMATS[2:4])
@pytest.mark.parametrize("dyadic", [False, True])
def test_ops_event_accum_repeated_words_match_reference(hw, K, dyadic):
    """``ops.event_accum`` on the CPU adds a repeated live word once per
    occurrence, as the JAX oracle does, with and without a batch axis."""
    fmt = tenc.make_format(hw, K)
    words, counts = repeated_queues(fmt, 2, 4, 12, seed=hw + 1)
    rng = np.random.default_rng(hw + 2)
    w, vm = _membrane_and_weights(rng, 2, hw, K, 4, 16, dyadic)
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    want = _jax_event_accum(words, counts, w, vm, **kw)
    held = dict(dyadic=dyadic, words=words, counts=counts, w=w, vm=vm, **kw)
    _assert_held(tops.event_accum(words, counts, w, vm, **kw).numpy(), want,
                 **held)
    assert torch.equal(tops.event_accum(words[1], counts[1], w, vm[1], **kw),
                       tops.event_accum(words, counts, w, vm, **kw)[1])


def test_repeated_words_ordered_gather_bf16_equals_plain():
    """In bf16 on a 1/4 grid (every partial sum exact in bf16) the ordered
    gather with multiplicities equals B4's bf16 plain version bit for bit;
    the multiplicities are what reach the sum (without them it differs)."""
    fmt = tenc.make_format(9, 3)
    words, counts = repeated_queues(fmt, 2, 3, 16, seed=3)
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.integers(-4, 5, (3, 3, 3, 8)) / 4.0)
                         .astype(np.float32)).bfloat16()
    vm = torch.from_numpy((rng.integers(-8, 9, (2, 9, 9, 8)) / 4.0)
                          .astype(np.float32)).bfloat16()
    kw = dict(K=3, n_win=3, depth=9, H=9, W=9, init=vm)
    mult = tea.event_mult_plain(words, counts, n_win=3, bits=2)
    got = tref.fused_spike_accum_ordered_ref(mult, w, multiplicity=True, **kw)
    want = tea.event_accum_plain(words, counts, w, vm, K=3, n_win=3, bits=2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(tref.fused_spike_accum_ordered_ref(mult, w, **kw),
                           want)


# --- the engine's queue backend and infer ------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(backend, mode, input_mode, weight_bits, B=16):
    """The JAX engine at B=16 (rows are independent in the reference, so a
    smaller batch is its prefix): numpy logits and stats."""
    params, th = dyadic_net(SPEC, HW, C)
    cfg = jengine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, T=3,
                            mode=mode, depth=2, input_mode=input_mode,
                            weight_bits=weight_bits)
    lj, sj = jengine.infer_batch(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], cfg, jnp.asarray(images(B, HW, C)),
        backend=backend)
    return np.asarray(lj), {f: np.asarray(getattr(sj, f))
                            for f in STAT_FIELDS}


def _port(backend, mode, input_mode, weight_bits, B):
    params, th = dyadic_net(SPEC, HW, C)
    cfg = tengine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, T=3,
                            mode=mode, depth=2, input_mode=input_mode,
                            weight_bits=weight_bits)
    return tengine.infer_batch(params, th, cfg, images(16, HW, C)[:B],
                               backend=backend, device="cpu")


def assert_matches(lt, st, lj, sj, B):
    np.testing.assert_array_equal(lt.numpy(), lj[:B])
    for f in STAT_FIELDS:
        got = getattr(st, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), sj[f][:B], err_msg=f)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("mode", jneuron.MODES)
def test_queue_backend_exact_on_dyadic_net(mode, input_mode, B):
    """queue == the reference's word-level queue backend, logits and all
    five stats, at depth 2 (overflowing)."""
    lj, sj = _reference("queue", mode, input_mode, None)
    lt, st = _port("queue", mode, input_mode, None, B)
    assert_matches(lt, st, lj, sj, B)
    assert int(sj["overflow"][:B].sum()) > 0


@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("mode", jneuron.MODES)
def test_queue_backend_exact_with_int8_head(mode, input_mode):
    lj, sj = _reference("queue", mode, input_mode, 8)
    lt, st = _port("queue", mode, input_mode, 8, 3)
    assert_matches(lt, st, lj, sj, 3)


def test_queue_backend_gaussian_net():
    """Gaussian weights: stats exact, logits to 1e-4 (the head's product
    sums in another order than XLA's; the conv stages are bit-exact)."""
    rng = np.random.default_rng(5)
    plan = jengine.compile_plan(SPEC, HW, C)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.normal(0, 0.5, (3, 3, cp.in_c, cp.out_c)),
            "b": np.full(cp.out_c, 0.05)}
    params[plan.out.index] = {"w": rng.normal(size=(plan.out.n_in, 10)),
                              "b": np.zeros(10)}
    params = [{k: v.astype(np.float32) for k, v in p.items()} for p in params]
    th = [np.float32(1.0)] * plan.n_layers
    imgs = rng.random((4, HW, HW, C)).astype(np.float32)
    kw = dict(spec=SPEC, input_hw=HW, input_c=C, T=3, mode="mttfs_cont",
              depth=8, input_mode="binary")
    lj, sj = jengine.infer_batch(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], jengine.SNNConfig(**kw),
        jnp.asarray(imgs), backend="queue")
    lt, st = tengine.infer_batch(params, th, tengine.SNNConfig(**kw), imgs,
                                 backend="queue", device="cpu")
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("backend", ["queue", "dense"])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
def test_infer_matches_reference_and_batch_rows(backend, input_mode):
    """Per-sample ``infer``: the reference's per-sample shapes and values,
    and bit for bit the sample's row of ``infer_batch``."""
    params, th = dyadic_net(SPEC, HW, C)
    kw = dict(spec=SPEC, input_hw=HW, input_c=C, T=3, mode="mttfs", depth=2,
              input_mode=input_mode)
    imgs = images(3, HW, C, seed=4)
    lb, sb = tengine.infer_batch(params, th, tengine.SNNConfig(**kw), imgs,
                                 backend=backend, device="cpu")
    for i in range(3):
        lt, st = tengine.infer(params, th, tengine.SNNConfig(**kw), imgs[i],
                               backend=backend, device="cpu")
        assert lt.shape == (10,) and st.overflow.shape == ()
        assert torch.equal(lt, lb[i])
        for f in STAT_FIELDS:
            assert torch.equal(getattr(st, f), getattr(sb, f)[i]), f
    lj, sj = jengine.infer(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], jengine.SNNConfig(**kw),
        jnp.asarray(imgs[2]), backend=backend)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)


def test_queue_mask_contract_padded_equals_unpadded():
    params, th = dyadic_net(SPEC, HW, C)
    cfg = tengine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, T=3,
                            mode="mttfs", depth=4, input_mode="binary")
    imgs = images(4, HW, C, seed=2)
    padded = imgs.copy()
    padded[3:] = images(4, HW, C, seed=7)[3:]
    lp, sp = tengine.infer_batch_masked(params, th, cfg, padded, 3,
                                        backend="queue", device="cpu")
    lu, su = tengine.infer_batch(params, th, cfg, imgs[:3], backend="queue",
                                 device="cpu")
    assert torch.equal(lp, lu)
    for f in STAT_FIELDS:
        assert torch.equal(getattr(sp, f), getattr(su, f)), f


def test_available_backends_match_reference():
    assert set(tengine.available_backends()) == set(
        jengine.available_backends())
    assert {"dense", "dense_unrolled", "queue"} <= set(
        tengine.available_backends())


def test_cpu_word_path_never_counts_launches():
    tops.reset_launch_counts()
    _port("queue", "mttfs", "binary", None, 2)
    tops.moe_gather(torch.ones((4, 3)), torch.tensor([0, -1],
                                                     dtype=torch.int32))
    assert set(tops.launch_counts) == {
        "fused_spike_accum", "quant_matmul", "fused_spike_accum_sparse",
        "event_accum", "spike_compact", "moe_gather"}
    assert all(v == 0 for v in tops.launch_counts.values())


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor (no silent fallback)."""
    occ = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tsc.spike_compact_cuda(occ, n_win=4, bits=2, depth=4, invalid=64)
    words = torch.zeros((1, 1, 9, 4), dtype=torch.int32)
    counts = torch.zeros((1, 1, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tea.event_accum_cuda(words, counts, torch.ones((3, 3, 1, 2)),
                             torch.zeros((1, 10, 10, 2)), K=3, n_win=4,
                             bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        tmg.moe_gather_cuda(torch.ones((4, 3)),
                            torch.zeros(2, dtype=torch.int32))


# --- C3: B4 and B5 at shapes past the card's old limits ---------------------

@pytest.mark.parametrize("hw,K,c_in,c_out,depth", [
    (20, 9, 2, 8, 6), (24, 11, 2, 8, 16), (100, 3, 2, 8, 16)])
@pytest.mark.parametrize("dyadic", [False, True])
def test_c3_event_accum_plain_matches_reference(hw, K, c_in, c_out, depth,
                                                dyadic):
    """At K = 9, 11 (the card's rolled gather, a decode of more than 64
    queues a cell) and a 100x100 map: B4's plain version (through ``ops``)
    against the JAX oracle, from the same queues (B5's plain version against
    the JAX AEQ builder); the (c, phase)-ordered oracle from the membrane on
    the occupancy, and the decode's bits against packed ``segment_keep``."""
    raster = _raster(2, c_in, hw, seed=hw + K, p_fire=0.3)
    fj, ft = jenc.make_format(hw, K), tenc.make_format(hw, K)
    qj = jaeq.aeq_from_raster(fj, jnp.asarray(raster), depth)
    qt = taeq.aeq_from_raster(ft, torch.from_numpy(raster), depth)
    for a, b in zip(qt, qj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(K * hw)
    if dyadic:
        w = (rng.integers(-128, 128, (K, K, c_in, c_out)) / 256.0)
        vm = np.round(rng.normal(size=(hw, hw, c_out)) * 16) / 16
    else:
        w = rng.normal(size=(K, K, c_in, c_out))
        vm = rng.normal(size=(hw, hw, c_out))
    w, vm = w.astype(np.float32), vm.astype(np.float32)
    kw = dict(K=K, n_win=fj.n_win, bits=fj.bits_coord)
    want = np.asarray(jref.event_accum_ref(qj.words[1], qj.counts[1],
                                           jnp.asarray(w), jnp.asarray(vm),
                                           **kw))
    w_t, vm_t = torch.from_numpy(w), torch.from_numpy(vm)
    got = tops.event_accum(qt.words[1], qt.counts[1], w_t, vm_t, **kw)
    occ = taeq.phase_occupancy(ft, torch.from_numpy(raster[1:]).permute(
        0, 2, 3, 1))
    ordered = tref.fused_spike_accum_ordered_ref(
        occ, w_t, K=K, n_win=ft.n_win, depth=depth, H=hw, W=hw,
        init=vm_t[None])[0]
    for name, g in (("plain", got), ("ordered", ordered)):
        if dyadic:
            np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), want, atol=1e-4,
                                       rtol=1e-4, err_msg=name)
    bits = tea.event_bits_plain(qt.words[1:], qt.counts[1:], n_win=ft.n_win,
                                bits=ft.bits_coord)
    np.testing.assert_array_equal(
        bits.numpy(), _packed(taeq.segment_keep(occ, depth).numpy()))


@pytest.mark.parametrize("K", [9, 11])
def test_c3_repeated_words_match_reference(K):
    """K = 9, 11 on queues that repeat positions: the multiplicities and the
    ordered oracle on them (B4's order of adds on the card) against the JAX
    oracle on dyadic weights, where every order gives the same sum. The
    map fills the window grid (hw = n_win * K), as every map of a net
    does: these queues name positions anywhere in the grid."""
    hw, c_in, c_out = {9: 27, 11: 22}[K], 2, 8
    fmt = tenc.make_format(hw, K)
    words, counts = repeated_queues(fmt, 2, c_in, 12, K)
    rng = np.random.default_rng(K)
    w = (rng.integers(-128, 128, (K, K, c_in, c_out)) / 256.0).astype(
        np.float32)
    vm = (np.round(rng.normal(size=(2, hw, hw, c_out)) * 16) / 16).astype(
        np.float32)
    kw = dict(K=K, n_win=fmt.n_win, bits=fmt.bits_coord)
    mult = tea.event_mult_plain(words, counts, n_win=fmt.n_win,
                                bits=fmt.bits_coord)
    assert int(mult.max()) >= 2
    got = tref.fused_spike_accum_ordered_ref(
        mult, torch.from_numpy(w), K=K, n_win=fmt.n_win,
        depth=fmt.n_win ** 2, H=hw, W=hw, init=torch.from_numpy(vm),
        multiplicity=True)
    for n in range(2):
        want = jref.event_accum_ref(jnp.asarray(words[n].numpy()),
                                    jnp.asarray(counts[n].numpy()),
                                    jnp.asarray(w), jnp.asarray(vm[n]), **kw)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want))


def test_c3_spike_compact_plain_past_the_old_depth_limit():
    """B5's plain version at depth 65,536 (the card once refused depth >
    58,103) against the JAX oracle: words and uncapped counts."""
    fmt = jenc.make_format(33, 3)
    occ = (np.random.default_rng(5).random((3, fmt.n_win ** 2))
           < 0.5).astype(np.int32)
    kw = dict(n_win=fmt.n_win, bits=fmt.bits_coord, depth=65_536,
              invalid=fmt.invalid_word)
    wj, cj = jref.spike_compact_ref(jnp.asarray(occ), **kw)
    wt, ct = tops.spike_compact(torch.from_numpy(occ), **kw)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_c3_decode_limit_names_its_bytes():
    """B4's decode holds one (n, c) cell's bits in shared memory: a 512x512
    map fits at K in {1, 3, 5, 7, 9, 11}; past about 1,360 it raises with
    its byte count."""
    for K in (1, 3, 5, 7, 9, 11):
        tea.check_decode_fits(K, -(-512 // K))
    n_win = -(-1400 // 3)
    nbytes = 4 * 9 * -(-n_win * n_win // 32)
    with pytest.raises(ValueError, match=f"{nbytes} bytes"):
        tea.check_decode_fits(3, n_win)
