"""Spike encodings and the paper's compressed Address-Event word format.

Port of ``repro.core.encoding``: the AE word format of Sec. 5.2 (Eq. 6-7,
including the fallback to the original encoding when no spare code point
is left) and the input codings (constant current, TTFS, rate). Formats are
plain ints; the packing helpers work on int32 tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

# status code points (stored in the spare patterns of the i-coordinate field)
STATUS_INVALID = 0   # empty queue slot / padding
STATUS_SEG_END = 1   # segment boundary marker (original encoding: status bits)


class AEFormat(NamedTuple):
    """Static description of an AE word layout for one feature-map geometry."""

    width: int          # feature map width W (maps are square, like the paper)
    kernel: int         # kernel size K
    n_win: int          # ceil(W / K) windows per dimension
    bits_coord: int     # bits per window coordinate (Eq. 6)
    compressed: bool    # False -> original encoding (2 explicit status bits)
    word_bits: int      # total bits per stored event word
    invalid_word: int   # the packed word representing an empty slot


def spare_patterns(width: int, kernel: int) -> int:
    """Number of unused bit patterns per coordinate field (paper: 6 for
    W=28, K=3)."""
    n_win = math.ceil(width / kernel)
    bits = max(1, math.ceil(math.log2(n_win))) if n_win > 1 else 1
    return (1 << bits) - n_win


def make_format(width: int, kernel: int, *, compressed: bool = True) -> AEFormat:
    """Build the AE word format for a (square) feature map of ``width``.

    Eq. (6): bits per coordinate = ceil(log2(W / K)).
    Eq. (7): if fewer than 1 spare pattern remains, the compressed encoding
    cannot carry in-band status -> fall back to the original encoding with
    2 explicit status bits (the CIFAR-10 10x10 stages: n_win=4, bits=2).
    """
    n_win = math.ceil(width / kernel)
    bits = max(1, math.ceil(math.log2(n_win))) if n_win > 1 else 1

    spare = (1 << bits) - n_win
    if compressed and spare < 1:
        compressed = False

    if compressed:
        word_bits = 2 * bits
        # status lives in the i-field's spare patterns: i == n_win + code
        invalid = ((n_win + STATUS_INVALID) << bits) | 0
    else:
        word_bits = 2 * bits + 2  # original: explicit 2 status bits
        invalid = ((STATUS_INVALID + 1) << (2 * bits)) | 0  # status=1 -> invalid

    return AEFormat(width=width, kernel=kernel, n_win=n_win, bits_coord=bits,
                    compressed=compressed, word_bits=word_bits,
                    invalid_word=invalid)


def pack_events(fmt: AEFormat, i_c, j_c, valid) -> torch.Tensor:
    """Pack window coordinates into int32 AE words; invalid lanes carry
    ``fmt.invalid_word`` (in-band or explicit status, per the format)."""
    i_c = torch.as_tensor(i_c, dtype=torch.int32)
    j_c = torch.as_tensor(j_c, dtype=torch.int32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=i_c.device)
    word = (i_c << fmt.bits_coord) | j_c       # status bits 00 = valid event
    return torch.where(valid, word,
                       torch.full_like(word, fmt.invalid_word))


def unpack_events(fmt: AEFormat, words):
    """Inverse of :func:`pack_events` -> (i_c, j_c, valid)."""
    words = torch.as_tensor(words, dtype=torch.int32)
    bits = fmt.bits_coord
    mask = (1 << bits) - 1
    i_c = (words >> bits) & mask
    j_c = words & mask
    if fmt.compressed:
        valid = i_c < fmt.n_win  # spare patterns of the i-field are status
    else:
        valid = ((words >> (2 * bits)) & 0x3) == 0
    return i_c, j_c, valid


def word_nbytes(fmt: AEFormat) -> int:
    """Bytes a word occupies in the event buffer (power-of-two storage)."""
    for nb in (1, 2, 4):
        if fmt.word_bits <= 8 * nb:
            return nb
    raise ValueError(f"AE word of {fmt.word_bits} bits does not fit int32")


def encode_constant_current(image: torch.Tensor, T: int) -> torch.Tensor:
    """snntoolbox-style analog input: the image is applied as a constant
    input current at every algorithmic time step. Returns a (T, *shape)
    view of ``image``."""
    return image.expand((T,) + tuple(image.shape))


def encode_ttfs(image: torch.Tensor, T: int, theta: float = 0.1) -> torch.Tensor:
    """TTFS input coding: brighter pixels spike earlier; one spike per pixel.

    Pixel x (in [0,1]) spikes at step floor((1-x)*(T-1)); pixels below
    ``theta`` never spike. Returns a time-major (T, *shape) 0/1 raster in
    ``image``'s dtype.
    """
    x = torch.clamp(image, 0.0, 1.0)
    t_spike = torch.floor((1.0 - x) * (T - 1)).to(torch.int32)
    ts = torch.arange(T, dtype=torch.int32, device=image.device)
    ts = ts.reshape((T,) + (1,) * image.dim())
    raster = (ts == t_spike) & (x > theta)
    return raster.to(image.dtype)


def encode_rate(image: torch.Tensor, T: int,
                generator: torch.Generator) -> torch.Tensor:
    """Rate coding: a Bernoulli(x) spike per step for each pixel x (clipped
    to [0, 1]). Returns a (T, *shape) 0/1 raster in ``image``'s dtype.

    The uniforms come from ``generator`` alone (the reference's explicit
    key), never from the global RNG; it must live on ``image``'s device.
    """
    if generator.device.type != image.device.type:
        raise ValueError(
            f"encode_rate: the generator is on {generator.device} but the "
            f"image on {image.device}; pass a generator on the image's "
            "device")
    x = torch.clamp(image, 0.0, 1.0)
    u = torch.rand((T,) + tuple(image.shape), generator=generator,
                   dtype=image.dtype, device=image.device)
    return (u < x).to(image.dtype)
