"""Shared utilities: logging, profiling hooks, serialization helpers."""


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (capacity sizing for device buffers)."""
    p = 1
    while p < n:
        p *= 2
    return p
