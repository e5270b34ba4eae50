"""Procedural datasets — a numpy copy of ``repro.data.synthetic`` that yields
identical arrays per seed (no MNIST/SVHN/CIFAR files are needed).

- ``digits``  (MNIST-like, 28x28x1): seven-segment-style digit renderings with
  random offset/thickness/noise. Crucially, class "1" lights the fewest
  pixels, structurally reproducing the paper's Fig. 8 outlier (digit 1
  generates the fewest spikes).
- ``svhn``    (32x32x3): the same digits, colored, on textured backgrounds.
- ``cifar``   (32x32x3): 10 procedural shape/texture classes.
- ``tokens``  : synthetic LM token streams with n-gram structure (so a
  language model has something learnable).

Everything is generated with numpy from an integer seed — fully reproducible
and shardable by slicing the sample index range.
"""
from __future__ import annotations

import numpy as np

# 7-segment layout per digit: segments (a,b,c,d,e,f,g)
#     aaa
#    f   b
#     ggg
#    e   c
#     ddd
_SEGMENTS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcfgd",
}


def _draw_digit(rng: np.random.Generator, digit: int, hw: int) -> np.ndarray:
    img = np.zeros((hw, hw), np.float32)
    th = rng.integers(2, 4)                       # stroke thickness
    m = rng.integers(4, 7)                        # margin
    x0, x1 = m, hw - m
    y0, ymid, y1 = m, hw // 2, hw - m
    jitter = lambda: rng.integers(-1, 2)

    def hline(y, xa, xb):
        y = np.clip(y + jitter(), 0, hw - th)
        img[y : y + th, max(xa, 0) : min(xb, hw)] = 1.0

    def vline(x, ya, yb):
        x = np.clip(x + jitter(), 0, hw - th)
        img[max(ya, 0) : min(yb, hw), x : x + th] = 1.0

    segs = _SEGMENTS[digit]
    if "a" in segs: hline(y0, x0, x1)
    if "d" in segs: hline(y1 - th, x0, x1)
    if "g" in segs: hline(ymid, x0, x1)
    if "f" in segs: vline(x0, y0, ymid)
    if "b" in segs: vline(x1 - th, y0, ymid)
    if "e" in segs: vline(x0, ymid, y1)
    if "c" in segs: vline(x1 - th, ymid, y1)

    # random translate
    sy, sx = rng.integers(-2, 3, size=2)
    img = np.roll(img, (sy, sx), axis=(0, 1))
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_digits(n: int, seed: int = 0, hw: int = 28):
    """MNIST-like: returns (images (n,hw,hw,1) float32 in [0,1], labels (n,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = np.stack([_draw_digit(rng, int(d), hw) for d in labels])
    return images[..., None].astype(np.float32), labels.astype(np.int32)


def make_svhn_like(n: int, seed: int = 0, hw: int = 32):
    """SVHN-like: colored digit on a textured color background."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 10, size=n)
    imgs = np.empty((n, hw, hw, 3), np.float32)
    for i, d in enumerate(labels):
        glyph = _draw_digit(rng, int(d), hw)
        bg = rng.uniform(0.1, 0.5, size=3).astype(np.float32)
        fg = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
        noise = rng.normal(0, 0.08, (hw, hw, 3)).astype(np.float32)
        img = bg[None, None] + glyph[..., None] * (fg - bg)[None, None] + noise
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int32)


def _shape_mask(rng, kind: int, hw: int) -> np.ndarray:
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    cy, cx = rng.uniform(hw * 0.35, hw * 0.65, size=2)
    r = rng.uniform(hw * 0.2, hw * 0.38)
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    if kind == 0:   return (d2 < r * r).astype(np.float32)                 # disc
    if kind == 1:   return ((abs(yy - cy) < r) & (abs(xx - cx) < r)).astype(np.float32)
    if kind == 2:   return ((abs(yy - cy) + abs(xx - cx)) < r).astype(np.float32)
    if kind == 3:   return ((abs(yy - cy) < r / 3) | (abs(xx - cx) < r / 3)).astype(np.float32)
    if kind == 4:   return ((d2 > (r * 0.5) ** 2) & (d2 < r * r)).astype(np.float32)  # ring
    if kind == 5:   return (((yy - cy) > -r) & ((yy - cy) < 0) & (abs(xx - cx) < (yy - cy + r))).astype(np.float32)
    if kind == 6:   return ((np.sin(yy / 2) * np.sin(xx / 2)) > 0.3).astype(np.float32)
    if kind == 7:   return ((abs(yy - cy) < r) & (abs(xx - cx) < r / 3)).astype(np.float32)
    if kind == 8:   return ((abs(yy - cy) < r / 3) & (abs(xx - cx) < r)).astype(np.float32)
    return ((((yy + xx) % 8) < 3) & (d2 < r * r)).astype(np.float32)


def make_cifar_like(n: int, seed: int = 0, hw: int = 32):
    """CIFAR-like: 10 shape/texture classes, colored, noisy."""
    rng = np.random.default_rng(seed + 2)
    labels = rng.integers(0, 10, size=n)
    imgs = np.empty((n, hw, hw, 3), np.float32)
    for i, k in enumerate(labels):
        mask = _shape_mask(rng, int(k), hw)
        bg = rng.uniform(0.0, 0.45, size=3).astype(np.float32)
        fg = rng.uniform(0.55, 1.0, size=3).astype(np.float32)
        img = bg[None, None] + mask[..., None] * (fg - bg)[None, None]
        img += rng.normal(0, 0.1, (hw, hw, 3)).astype(np.float32)
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int32)


def make_tokens(n_tokens: int, vocab: int, seed: int = 0, order: int = 2):
    """Markov token stream: learnable n-gram structure for LM training.

    A fixed random transition structure maps the previous ``order`` tokens to
    a peaked next-token distribution (top-8 candidates at 80% mass).
    """
    rng = np.random.default_rng(seed + 3)
    ctx_hash_w = rng.integers(1, 2**31 - 1, size=order)
    n_buckets = 4096
    # Zipf-skewed candidate pool: the corpus has learnable *unigram*
    # structure too, so even tiny smoke models show loss movement fast,
    # while the bucket structure rewards real context modeling.
    zipf_p = 1.0 / np.arange(1, vocab + 1)
    zipf_p /= zipf_p.sum()
    cand = rng.choice(vocab, size=(n_buckets, 8), p=zipf_p)

    out = np.empty(n_tokens, np.int64)
    out[:order] = rng.integers(0, vocab, size=order)
    u = rng.random(n_tokens)
    pick = rng.integers(0, 8, size=n_tokens)
    noise = rng.choice(vocab, size=n_tokens, p=zipf_p)
    for i in range(order, n_tokens):
        h = int((out[i - order : i] * ctx_hash_w).sum() % n_buckets)
        out[i] = cand[h, pick[i]] if u[i] < 0.8 else noise[i]
    return out.astype(np.int32)


DATASETS = {
    "mnist": make_digits,
    "svhn": make_svhn_like,
    "cifar10": make_cifar_like,
}
