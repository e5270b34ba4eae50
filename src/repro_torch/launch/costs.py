"""Analytic per-cell cost model — the primary §Roofline source (a copy of
``repro.launch.costs`` over the port's ``ArchConfig``; pure arithmetic, so
its numbers equal the reference's exactly).

Why analytic: the reference's XLA ``cost_analysis()`` counts a scan body
once, not x trip-count, so its dry run leans on this table. The port's dry
run (``launch/dryrun.py``) traces every period and microbatch, so its
traced FLOPs and bytes need no correction; it reads its collective bytes
from here, since the port partitions nothing and no partitioned program
exists to read them from. Every formula is written out below.

All quantities are PER DEVICE per step unless suffixed _total.

FLOPs (standard MFU accounting):
  matmul params: 2 * N_active_nonemb * tokens            (fwd)
  vocab head:    2 * tokens * d * padded_vocab
  attention:     4 * B * S^2 * H * hd * 0.5 (causal) per attn layer (scores+PV)
  mamba scan:    ~9 * tokens * d_inner * d_state         (exp, 2 mul-add, dot)
  mlstm scan:    ~8 * tokens * du * hd                   (C update + retrieve)
  slstm scan:    ~2 * tokens * d * 4*hd                  (recurrent gates)
  train = 3x fwd (bwd ~ 2x fwd);  decode: tokens = B, attention reads cache.

HBM bytes:
  train:  params touched ~ (2 bf16 reads fwd+bwd + fp32 grad w + 2x adam m,v
          r/w + fp32 master r/w) ~ 26 B/param / chips
          + activations: depth * tokens * d * 2 B * remat_factor / chips
  prefill: params bf16 read + activations + KV cache write
  decode: params bf16 read (all of them, batch small) + cache read
Collective bytes (per device):
  FSDP all-gather: params_bytes_bf16 / model_shards * (microbatches fwd
                   + 1 bwd regather) + grad reduce-scatter fp32 ~ 2x params/
                   model_shards   [ZeRO-3 over 'data']
  TP activation collectives: 2 all-reduce (or ag+rs) of tokens*d*2B per layer
                   / data_shards
  MoE all-to-all: tokens * top_k * d * 2B / chips * 2 (dispatch+combine)
  pod axis adds a second DP tier: grads reduce additionally across pods.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import configs

BF16 = 2
F32 = 4


@dataclass
class CellCost:
    flops_device: float
    hbm_bytes_device: float
    coll_bytes_device: float
    flops_total: float
    notes: str


def _counts(cfg):
    """(attn_layers, mamba_layers, mlstm_layers, slstm_layers)."""
    pat = cfg.block_pattern
    reps = cfg.n_layers // len(pat)
    return (reps * sum(k == "attn" for k in pat),
            reps * sum(k == "mamba" for k in pat),
            reps * sum(k == "mlstm" for k in pat),
            reps * sum(k == "slstm" for k in pat))


def active_params(cfg) -> int:
    """Parameters touched per token (MoE counts top_k + shared experts)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers)
        if i % m.every_k_layers == m.every_k_layers - 1)
    all_expert = n_moe_layers * m.n_experts * 3 * cfg.d_model * m.expert_d_ff
    act_expert = n_moe_layers * m.top_k * 3 * cfg.d_model * m.expert_d_ff
    return total - all_expert + act_expert


def model_flops(cfg, n_tokens: int, *, train: bool) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)."""
    mult = 6.0 if train else 2.0
    return mult * active_params(cfg) * n_tokens


def nonemb_active_params(cfg) -> float:
    n = active_params(cfg)
    emb = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return max(n - emb, 0)


def cell_cost(arch: str, shape_name: str, *, multi_pod: bool = False,
              remat_factor: float = 2.0, dp: int = 16, tp: int = 16,
              profile: str = "auto", microbatches: int | None = None,
              moe_ep: bool = False, cfg=None) -> CellCost:
    """Knobs mirror the dry-run overrides so hypotheses can be napkin-mathed
    before lowering: dp/tp mesh split, dp_only profile (pure replication),
    microbatch count, moe_ep (expert-parallel dispatch instead of
    width-sharded experts). ``cfg`` is required — ``arch`` only labels the
    cell (the registry the name used to resolve against was removed)."""
    if cfg is None:
        raise ValueError(
            f"cell_cost({arch!r}, {shape_name!r}): pass cfg= explicitly — "
            "the LM config zoo was removed (dead code, flagged by "
            "`python -m repro.audit`); reduced configs live in "
            "tests/_smoke_archs.py")
    shape = configs.SHAPES[shape_name]
    B, S = shape["batch"], shape["seq"]
    kind = shape["kind"]
    chips = (2 if multi_pod else 1) * dp * tp
    model_shards = 1 if profile == "dp_only" else tp
    data_shards = chips // model_shards

    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.kv_heads
    nA, nM, nX, nSl = _counts(cfg)
    enc_layers = cfg.n_enc_layers if cfg.enc_dec else 0

    tokens = B * S if kind in ("train", "prefill") else B
    N_act = nonemb_active_params(cfg)
    pbytes_total = cfg.param_count() * BF16

    # ---- FLOPs (fwd) ----
    f_mat = 2.0 * N_act * tokens
    f_head = 2.0 * tokens * d * cfg.padded_vocab
    if kind == "decode":
        f_attn = (nA + enc_layers) * 4.0 * B * S * H * hd  # cache reads
    else:
        f_attn = (nA + enc_layers) * 4.0 * B * S * S * H * hd * 0.5
    if cfg.mamba:
        f_ssm = nM * 9.0 * tokens * cfg.mamba.d_inner * cfg.mamba.d_state
    else:
        f_ssm = 0.0
    du = 2 * d
    f_xl = nX * 8.0 * tokens * du * (du // max(H, 1)) + \
        nSl * 2.0 * tokens * d * 4 * (d // max(H, 1))
    fwd = f_mat + f_head + f_attn + f_ssm + f_xl
    flops_total = fwd * (3.0 if kind == "train" else 1.0)

    # ---- HBM bytes per device ----
    if kind == "train":
        opt_shards = 1 if profile == "dp_only" else chips
        param_traffic = cfg.param_count() * 26.0 / opt_shards
        act = cfg.n_layers * tokens * d * BF16 * remat_factor / chips
        hbm = param_traffic + act
    elif kind == "prefill":
        cache_w = (nA + enc_layers) * B * S * KV * hd * 2 * BF16 / chips
        act = cfg.n_layers * tokens * d * BF16 / chips
        hbm = pbytes_total / chips + act + cache_w
    else:  # decode
        cache_r = nA * B * S * KV * hd * 2 * BF16 / chips
        state_r = (nM * (cfg.mamba.d_inner * cfg.mamba.d_state if cfg.mamba
                         else 0) + nX * H * (du // max(H, 1)) ** 2) * B * F32 / chips
        hbm = active_paramsbytes(cfg) / chips + cache_r + state_r

    # ---- collective bytes per device ----
    mb = max(microbatches if microbatches is not None else cfg.microbatches, 1)
    if profile == "dp_only":
        # pure DP: only the gradient all-reduce (ring: ~2 x bytes/device)
        if kind == "train":
            coll = 2.0 * cfg.param_count() * F32
        else:
            coll = 0.0
    elif kind == "train":
        fsdp_ag = pbytes_total / model_shards * (mb + 1)
        grad_rs = cfg.param_count() * F32 / model_shards
        pod_extra = cfg.param_count() * F32 / model_shards if multi_pod else 0
        # per-layer TP activation all-reduces; with expert-parallel MoE the
        # FFN half becomes an all-to-all of the routed tokens instead
        layer_factor = 1.0 if (cfg.moe and moe_ep) else 2.0
        tp_act = layer_factor * cfg.n_layers * (tokens / data_shards) * d * BF16
        moe_a2a = (2.0 * tokens * cfg.moe.top_k * d * BF16 / chips
                   if cfg.moe else 0.0)
        coll = fsdp_ag + grad_rs + pod_extra + tp_act + moe_a2a
    elif kind == "prefill":
        tp_act = 2.0 * cfg.n_layers * (tokens / data_shards) * d * BF16
        coll = pbytes_total / model_shards + tp_act
    else:
        tp_act = 2.0 * cfg.n_layers * (tokens / data_shards) * d * BF16
        coll = tp_act + active_paramsbytes(cfg) / model_shards

    return CellCost(
        flops_device=flops_total / chips,
        hbm_bytes_device=hbm,
        coll_bytes_device=coll,
        flops_total=flops_total,
        notes=f"attn={nA},mamba={nM},mlstm={nX},slstm={nSl},enc={enc_layers}",
    )


def active_paramsbytes(cfg) -> float:
    return active_params(cfg) * BF16
