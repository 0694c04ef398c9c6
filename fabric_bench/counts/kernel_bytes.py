"""Bytes the packed-vote kernels need, and their least time on the card.

Counted as each input byte read once and each output byte written once,
on the canonical planes of ``N`` gradient elements from ``W`` workers
(``repro_torch.kernels.ref``: 32 sign bits a word):

- ``sign_pack``: reads W value planes, writes W word planes;
- ``vote_combine``: reads the W routed word planes and the gate words,
  writes the sign and mask word planes;
- ``unpack_ternary``: reads the sign and mask words, writes the decoded
  plane in the gradients' dtype.

At ``N = 88,080,384`` bf16 elements and ``W = 4`` these give 0.2235,
0.0230 and 0.0592 ms at 3.35 TB/s, the bounds the port's kernel table
states.
"""
from __future__ import annotations

WORD_BITS = 32


def _words(n: int) -> float:
    return n / 8.0                       # bytes of one sign bit an element


def sign_pack_bytes(n: int, workers: int, value_bytes: int = 2) -> float:
    return workers * n * value_bytes + workers * _words(n)


def vote_combine_bytes(n: int, workers: int) -> float:
    return workers * _words(n) + _words(n) + 2 * _words(n)


def unpack_ternary_bytes(n: int, out_bytes: int = 2) -> float:
    return 2 * _words(n) + n * out_bytes


def vote_bytes(n: int, workers: int, value_bytes: int = 2) -> float:
    """The three kernels' bytes for one aggregation of ``n`` voted
    elements (decoded into the gradients' dtype)."""
    return (sign_pack_bytes(n, workers, value_bytes)
            + vote_combine_bytes(n, workers)
            + unpack_ternary_bytes(n, value_bytes))


def least_ms(nbytes: float, bytes_per_s: float) -> float:
    return nbytes / bytes_per_s * 1e3
