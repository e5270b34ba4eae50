"""Queues that the engine never writes, for B4's tests on the CPU and the card.

Imports neither jax nor the reference package, so the card-only tests can
use it on a machine that has only PyTorch.
"""
import numpy as np
import torch


def repeated_queues(fmt, rows, c_in, D, seed, off_grid=False):
    """(rows, c_in, K², D) int32 words and (rows, c_in, K²) counts: each
    queue's live words name up to 5 distinct grid positions 1-4 times each,
    in shuffled slot order (truncated to D), then the format's invalid
    word. With ``off_grid`` some queues also hold a live word past the grid
    (j_c = n_win, which the format must leave room for)."""
    rng = np.random.default_rng(seed)
    K2, P, nw, bits = fmt.kernel ** 2, fmt.n_win ** 2, fmt.n_win, \
        fmt.bits_coord
    words = np.full((rows, c_in, K2, D), fmt.invalid_word, dtype=np.int32)
    counts = np.zeros((rows, c_in, K2), dtype=np.int32)
    for idx in np.ndindex(rows, c_in, K2):
        pos = rng.choice(P, size=rng.integers(0, min(P, 5) + 1),
                         replace=False)
        q = rng.permutation(np.repeat(pos, rng.integers(1, 5, pos.size)))
        w = list(((q // nw) << bits) | (q % nw))
        if off_grid and rng.random() < 0.3:
            w.insert(int(rng.integers(0, len(w) + 1)),
                     (int(rng.integers(0, nw)) << bits) | nw)
        w = w[:D]
        words[idx][:len(w)] = w
        counts[idx] = len(w)
    return torch.from_numpy(words), torch.from_numpy(counts)
