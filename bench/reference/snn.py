"""The served SNN in plain PyTorch: the benchmark's reference.

One plan walk over a batch of (H, W, C) images, written from the paper's
semantics (Sec. 3-5) and nothing else: the analog first layer is a SAME
conv applied as a constant current every step; every later conv stage
reads its input spikes through address-event queues, one per (step,
channel, kernel phase), each of fixed ``depth`` and filled in
window-row-major order, so events past ``depth`` are dropped and counted;
each kept event adds its K x K weights into the membrane; the neuron fires
(``mttfs_cont``: every step the membrane is above threshold, no reset),
pooling ORs a window of spikes; the classifier accumulates its membrane
over all steps without a threshold. It returns the logits and the integer
statistics (events in, spikes out, scalar adds, queue words, overflow) of
every weighted layer.

The order of the membrane's adds is the queue order: channel, then phase
(the order in which the paper's accelerator drains its queues). Each
output takes at most one event of a queue, because the phases interlace,
so that order fixes every partial sum. The analog conv and the classifier
are cuDNN / cuBLAS products in float32 with TF32 off, unless a caller asks
for the lower-precision control (``tf32=True``).

It imports nothing from the program under test.
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Stage(NamedTuple):
    """One conv stage with its optional fused pool."""

    index: int      # spec token index == params slot
    in_hw: int
    in_c: int
    out_c: int
    k: int
    pool: int       # 0: no pool
    out_hw: int
    n_win: int      # ceil(in_hw / k): queue windows per side


class Head(NamedTuple):
    index: int
    n_in: int
    n_out: int


class Outputs(NamedTuple):
    """Per image: logits (N, n_out) float32 and int32 stats, (N, L) per
    layer field and (N,) overflow."""

    logits: torch.Tensor
    events_in: torch.Tensor
    spikes_out: torch.Tensor
    add_ops: torch.Tensor
    queue_words: torch.Tensor
    overflow: torch.Tensor


STAT_FIELDS = ("events_in", "spikes_out", "add_ops", "queue_words",
               "overflow")


def parse(spec: str):
    """'32C3-P3-10' -> [('conv', 32, 3), ('pool', 3), ('dense', 10)]."""
    out = []
    for tok in spec.split("-"):
        if m := re.fullmatch(r"(\d+)C(\d+)", tok):
            out.append(("conv", int(m[1]), int(m[2])))
        elif m := re.fullmatch(r"P(\d+)", tok):
            out.append(("pool", int(m[1])))
        elif re.fullmatch(r"\d+", tok):
            out.append(("dense", int(tok)))
        else:
            raise ValueError(f"bad token {tok!r} in spec {spec!r}")
    return out


def plan(spec: str, hw: int, c: int):
    """(conv stages, head) of ``spec`` at an hw x hw x c input."""
    layers = parse(spec)
    stages, i = [], 0
    while i < len(layers) - 1:
        _, cout, k = layers[i]
        pool = layers[i + 1][1] if layers[i + 1][0] == "pool" else 0
        out_hw = hw // pool if pool else hw
        stages.append(Stage(i, hw, c, cout, k, pool, out_hw,
                            math.ceil(hw / k)))
        c, hw = cout, out_hw
        i += 2 if pool else 1
    return stages, Head(len(layers) - 1, hw * hw * c, layers[-1][1])


def _span(p: torch.Tensor, k: int, size: int) -> torch.Tensor:
    """How many of the k kernel offsets of an event at coordinate p land
    inside a SAME conv's output of side ``size``."""
    n = torch.zeros_like(p)
    for d in range(k):
        t = p - d + k // 2
        n += ((t >= 0) & (t < size)).to(p.dtype)
    return n


def _fire(stage: Stage, cur: torch.Tensor, vth, T: int, v_init_frac: float):
    """The time loop of one stage: (B, T, H, W, C) currents -> the emitted
    (B, T, H', W', C) 0/1 raster (mttfs_cont, then the OR pool)."""
    v = (v_init_frac * vth).expand(cur.shape[2:])
    frames = []
    for t in range(T):
        v = v + cur[:, t]
        sp = (v > vth).to(cur.dtype)
        if stage.pool:
            p = stage.pool
            B, H, W, C = sp.shape
            ho = H // p
            sp = sp[:, :ho * p, :ho * p].reshape(B, ho, p, ho, p, C)
            sp = (sp.amax(dim=(2, 4)) > 0).to(cur.dtype)
        frames.append(sp)
    return torch.stack(frames, dim=1)


def _conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 conv of channels-last (N, H, W, C) by HWIO weights."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding=w.shape[0] // 2)
    return out.permute(0, 2, 3, 1)


def _queues(stage: Stage, x: torch.Tensor, depth: int):
    """(N, H, W, C) 0/1 maps -> each queue's kept events as a bool map
    (N, n*K, n*K, C), and per row: events kept, events dropped, adds."""
    K, n, H = stage.k, stage.n_win, stage.in_hw
    N, C = x.shape[0], x.shape[-1]
    side = n * K
    m = F.pad(x, (0, 0, 0, side - H, 0, side - H)) > 0
    # queue (c, phase ky*K+kx) holds window (wy, wx) at wy*n + wx
    q = m.reshape(N, n, K, n, K, C).permute(0, 5, 2, 4, 1, 3)
    q = q.reshape(N, C, K * K, n * n)
    slot = torch.cumsum(q.to(torch.int32), dim=-1) - 1
    keep = q & (slot < depth)
    pos = torch.arange(side, device=x.device)
    span = _span(pos, K, H) * (pos < H)
    span_q = (span[:, None] * span[None, :]).reshape(n, K, n, K)
    span_q = span_q.permute(1, 3, 0, 2).reshape(K * K, n * n)
    kept = keep.sum((1, 2, 3), dtype=torch.int32)
    dropped = q.sum((1, 2, 3), dtype=torch.int32) - kept
    adds = (keep * span_q).sum((1, 2, 3)) * stage.out_c
    kept_map = keep.reshape(N, C, K, K, n, n).permute(0, 4, 2, 5, 3, 1)
    return kept_map.reshape(N, side, side, C), kept, dropped, adds


def _accumulate(stage: Stage, kept_map: torch.Tensor, w: torch.Tensor):
    """The charge each output takes from the kept events, added from zero
    queue by queue, channel first, then phase."""
    K, H, pad = stage.k, stage.in_hw, stage.k // 2
    side = stage.n_win * K
    N = kept_map.shape[0]
    dev = kept_map.device
    t = torch.arange(H, device=dev)
    hits, wts = [], []
    for ph in range(K * K):
        ky, kx = divmod(ph, K)
        dy = (ky - t + pad) % K         # the one offset whose input has
        dx = (kx - t + pad) % K         # this phase, per output coordinate
        sy, sx = t - pad + dy, t - pad + dx
        oky, okx = (sy >= 0) & (sy < side), (sx >= 0) & (sx < side)
        hit = kept_map[:, sy.clamp(0, side - 1)][:, :, sx.clamp(0, side - 1)]
        hits.append(hit & (oky[:, None, None] & okx[None, :, None]))
        wts.append(w[dy[:, None], dx[None, :]])         # (H, W, C, C_out)
    out = torch.zeros((N, H, H, w.shape[-1]), dtype=w.dtype, device=dev)
    zero = torch.zeros((), dtype=w.dtype, device=dev)
    for c in range(stage.in_c):
        for ph in range(K * K):
            out += torch.where(hits[ph][..., c, None], wts[ph][:, :, c],
                               zero)
    return out


@torch.no_grad()
def run(params, thresholds, cfg: dict, images: torch.Tensor, *,
        tf32: bool = False) -> Outputs:
    """The served net over (B, H, W, C) float32 ``images``.

    ``params``: one {'w', 'b'} per weighted spec token ({} for a pool),
    HWIO conv weights and an (n_in, n_out) classifier; ``thresholds``: one
    per token. ``cfg``: the configuration file's ``net`` block (spec,
    input_hw, input_c, T, depth, mode, v_init_frac). ``tf32=True`` lets
    the conv and the classifier run in TF32: the lower-precision control.
    """
    if cfg["mode"] != "mttfs_cont" or cfg["input_mode"] != "analog":
        raise ValueError("the reference walks mttfs_cont with analog input; "
                         f"got {cfg['mode']!r} / {cfg['input_mode']!r}")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _walk(params, thresholds, cfg, images)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _walk(params, thresholds, cfg, images):
    T, depth, frac = cfg["T"], cfg["depth"], cfg["v_init_frac"]
    stages, head = plan(cfg["spec"], cfg["input_hw"], cfg["input_c"])
    B = images.shape[0]
    dev = images.device
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows, raster = [], None
    for st in stages:
        w, b = params[st.index]["w"], params[st.index]["b"]
        vth = thresholds[st.index]
        if raster is None:
            c1 = _conv_same(images, w) + b
            cur = c1[:, None].expand(B, T, *c1.shape[1:])
            adds = torch.full((B,), T * st.in_hw * st.in_hw * st.in_c
                              * st.out_c * st.k * st.k, dtype=torch.int32,
                              device=dev)
            ev = ovf = zero
        else:
            x = raster.reshape(B * T, *raster.shape[2:])
            kept_map, kept, dropped, adds = _queues(st, x, depth)
            cur = _accumulate(st, kept_map, w)
            cur = cur.reshape(B, T, *cur.shape[1:]) + b
            ev = kept.reshape(B, T).sum(1, dtype=torch.int32)
            ovf = dropped.reshape(B, T).sum(1, dtype=torch.int32)
            adds = adds.reshape(B, T).sum(1).to(torch.int32)
        raster = _fire(st, cur, vth, T, frac)
        out = raster.sum((1, 2, 3, 4)).to(torch.int32)
        rows.append((ev, out, adds.to(torch.int32), ev, ovf))
    w, b = params[head.index]["w"], params[head.index]["b"]
    flat = raster.reshape(B, T, -1)
    logits = flat[:, 0] @ w
    for t in range(1, T):
        logits = logits + flat[:, t] @ w
    logits = logits + b * T
    ev = (flat > 0).sum((1, 2)).to(torch.int32)
    rows.append((ev, zero, ev * w.shape[1], zero, zero))
    ovf = rows[0][4]
    for r in rows[1:]:
        ovf = ovf + r[4]
    return Outputs(logits,
                   *(torch.stack([r[i] for r in rows], dim=1)
                     for i in range(4)),
                   ovf)


def run_blocks(params, thresholds, cfg, images, *, block: int,
               tf32: bool = False) -> Outputs:
    """:func:`run` over ``images`` (numpy or tensor, on any device) in
    blocks of ``block`` rows; outputs as CPU tensors."""
    dev = params[-1]["w"].device
    parts = []
    for i in range(0, len(images), block):
        x = torch.as_tensor(images[i:i + block], dtype=torch.float32,
                            device=dev)
        parts.append([a.cpu() for a in run(params, thresholds, cfg, x,
                                           tf32=tf32)])
    return Outputs(*(torch.cat([p[i] for p in parts])
                     for i in range(len(Outputs._fields))))
