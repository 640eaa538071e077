"""Shape-bucketing policy: variable-size axes (serving batch rows,
extraction lengths) are padded to power-of-two buckets, so a stream of
requests reuses a handful of shapes."""

from __future__ import annotations


def next_pow2(n: int, minimum: int = 1) -> int:
    """Smallest ``minimum * 2**k`` that is >= ``n`` (``minimum`` itself
    for ``n <= minimum``)."""
    if minimum <= 0:
        raise ValueError(f"minimum must be positive, got {minimum} "
                         "(a non-positive base can never reach n)")
    b = minimum
    while b < n:
        b *= 2
    return b
