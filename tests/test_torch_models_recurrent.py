"""The port's recurrent mixers (``models/ssm.py``: Mamba;
``models/xlstm.py``: mLSTM, sLSTM), every sublayer kind through
``transformer.block_apply``, and the stack's remat, against the JAX
package's on the same numpy inputs and the reference's weights carried
across; tolerances as in ``test_torch_models.py`` (bf16 ulps of the
output's largest magnitude where fp32 transcendentals round apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models import transformer as jtrans
from repro.models import xlstm as jxlstm
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttrans
from repro_torch.models import xlstm as txlstm

from _smoke_archs import SMOKES
from _torch_archs import TORCH_SMOKES
from test_torch_models import _np, _pair, _rng, _t, assert_close_ulps, \
    assert_equal


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

MAMBA = jssm.MambaConfig(d_inner=48, d_state=6, d_conv=4)
TMAMBA = tssm.MambaConfig(*MAMBA)


def _mamba(d=32):
    p, _ = jssm.mamba_init(jax.random.PRNGKey(8), d, MAMBA)
    # non-zero biases, so the conv and softplus see them
    rng = _rng(8)
    p["conv_b"] = jnp.asarray(rng.normal(size=p["conv_b"].shape) * 0.1,
                              jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.normal(size=p["dt_bias"].shape),
                               jnp.float32)
    return p


@pytest.mark.parametrize("seq_chunk", [0, 4])
def test_mamba_scan_state_and_decode(seq_chunk):
    """The depthwise causal conv, the selective scan (a time loop, in
    checkpointed chunks with ``seq_chunk``), ``want_state`` and the
    rolling-window decode. The conv taps, the scan's exp and softplus are
    fp32 (an ulp apart at most); the outputs are held within 1 bf16 ulp of
    their largest magnitude, the fp32 state within 2^-16 relative."""
    p = _mamba()
    rng = _rng(9)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    tp = _t(p)
    assert_close_ulps(jssm.mamba_apply(p, jx, MAMBA, seq_chunk=seq_chunk),
                      tssm.mamba_apply(tp, tx, TMAMBA, seq_chunk=seq_chunk), 1)
    jo, jc = jssm.mamba_apply(p, jx, MAMBA, want_state=True)
    to, tc = tssm.mamba_apply(tp, tx, TMAMBA, want_state=True)
    assert_close_ulps(jo, to, 1)
    assert_equal(jc.conv, tc.conv)
    assert_close_ulps(jc.h, tc.h, 2.0 ** -8)
    x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
    jx1, tx1 = _pair(x1, "bf16")
    jo, jc = jssm.mamba_decode(p, jx1, jc, MAMBA)
    to, tc = tssm.mamba_decode(tp, tx1, tc, TMAMBA)
    assert_close_ulps(jo, to, 1)
    assert_close_ulps(jc.conv, tc.conv, 2.0 ** -8)
    assert_close_ulps(jc.h, tc.h, 2.0 ** -8)


def test_seq_chunk_remat_changes_no_gradient():
    """``seq_chunk`` recomputes each chunk in the backward; the gradients
    equal the unchunked ones bit for bit (the same ops in the same
    order)."""
    tp = _t(_mamba())
    x = torch.as_tensor(_rng(10).normal(size=(2, 8, 32)).astype(np.float32))

    def grads(seq_chunk):
        leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()
                  if isinstance(v, torch.Tensor)}
        p = dict(tp, **leaves)
        out = tssm.mamba_apply(p, x.bfloat16(), TMAMBA, seq_chunk=seq_chunk)
        return torch.autograd.grad(out.float().square().sum(),
                                   list(leaves.values()))

    for a, b in zip(grads(0), grads(4)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_chunk", [0, 4])
def test_mlstm_and_slstm_scans_with_caches(seq_chunk):
    """mLSTM (matrix memory, exponential gating, max stabilizer) and sLSTM
    (block-diagonal recurrence): train forward (with ``seq_chunk``),
    ``want_state`` prefill and one cached decode step. Outputs within 1
    bf16 ulp of their largest magnitude; fp32 states within 2^-16
    relative."""
    rng = _rng(11)
    d, H = 32, 2
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, d)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    jx1, tx1 = _pair(x1, "bf16")
    for init, japply, tapply in (
            (jxlstm.mlstm_init, jxlstm.mlstm_apply, txlstm.mlstm_apply),
            (jxlstm.slstm_init, jxlstm.slstm_apply, txlstm.slstm_apply)):
        p, _ = init(jax.random.PRNGKey(12), d, H)
        tp = _t(p)
        jo, _ = japply(p, jx, H, seq_chunk=seq_chunk)
        to, _ = tapply(tp, tx, H, seq_chunk=seq_chunk)
        assert_close_ulps(jo, to, 1)
        jo, jc = japply(p, jx, H, want_state=True)
        to, tc = tapply(tp, tx, H, want_state=True)
        assert_close_ulps(jo, to, 1)
        for a, b in zip(jc, tc):
            assert_close_ulps(a, b, 2.0 ** -8)
        jo, jc = japply(p, jx1, H, cache=jc)
        to, tc = tapply(tp, tx1, H, cache=tc)
        assert_close_ulps(jo, to, 1)
        for a, b in zip(jc, tc):
            assert_close_ulps(a, b, 2.0 ** -8)


# ---------------------------------------------------------------------------
# transformer blocks and the stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_block_apply_matches_per_sublayer(arch):
    """Every sublayer kind of every smoke configuration, from the same
    input, in train mode: bit for bit but for an ulp where fp32 rounds
    apart (held within 1 bf16 ulp of the largest magnitude)."""
    cfg, tcfg = SMOKES[arch], TORCH_SMOKES[arch]
    p, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    x = _rng(13).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    for j in range(len(cfg.block_pattern)):
        pj = jax.tree.map(lambda a: a[0], p["decoder"][f"sub{j}"])
        cross = None
        if "cross" in pj:
            kv = _rng(14).normal(size=(2, 8, cfg.kv_heads, cfg.head_dim))
            cross = _pair(kv.astype(np.float32), "bf16")
        jh, _, jaux = jtrans.block_apply(
            pj, jx, cfg, j, cross_kv=cross and (cross[0], cross[0]))
        th, _, taux = ttrans.block_apply(
            _t(pj), tx, tcfg, j, cross_kv=cross and (cross[1], cross[1]))
        assert_close_ulps(jh, th, 1)
        np.testing.assert_allclose(_np(taux), _np(jaux), rtol=1e-6)


def test_stack_remat_gives_identical_results():
    """``cfg.remat != "none"`` checkpoints each period; the loss and every
    gradient equal the un-rematerialized ones bit for bit."""
    from repro_torch.training import train_loop

    base = TORCH_SMOKES["hybrid"]
    params, _ = TM.init_model(torch.Generator().manual_seed(0), base,
                              device="cpu")
    rng = _rng(15)
    batch = {k: torch.as_tensor(rng.integers(0, base.vocab, (2, 8)),
                                dtype=torch.int32) for k in ("tokens", "labels")}
    out = [train_loop.value_and_grad(dataclasses.replace(base, remat=r),
                                     params, batch)
           for r in ("none", "full")]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        assert torch.equal(a, b)
