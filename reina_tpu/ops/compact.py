"""Stream compaction without N-sized scatters.

Packing the set positions of an (N,) mask into a fixed-capacity buffer
is the classic XLA pattern ``zeros(K+1).at[slot].set(iota(N))`` — a
scatter with an N-sized update stream. Here it costs one cumsum plus
log2(N) rounds of K-sized gathers: the s-th set position is the first
index where the inclusive cumsum of the mask reaches s+1, found by
bisection.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .random import searchsorted_compact

I32 = jnp.int32


def concat_cumsum(weights, codes, n_seg: int):
    """Inclusive prefix sum over the concatenation
    ``[where(codes == s, weights, 0) for s in range(n_seg)]`` — one
    (n_seg * N,) cumsum whose segment s holds the running total of the
    weights of code s, offset by the totals of the segments before it.
    Returns (n_seg * N,) in ``weights``' dtype."""
    zero = jnp.zeros((), weights.dtype)
    return jnp.cumsum(jnp.concatenate(
        [jnp.where(codes == s, weights, zero) for s in range(n_seg)]))


def compact_indices(mask, capacity: int, head: int = 1 << 9):
    """Pack the indices of set positions of ``mask`` into a buffer.

    Args:
      mask: (N,) bool.
      capacity: static buffer size K.
      head: always-computed tier size; slots beyond it are filled under
        ``lax.cond`` only when the set count exceeds ``head``, so the
        common small-count day bisects only for the head.

    Returns:
      buf: (K,) int32 — the first K set indices in ascending order;
        unused slots hold N (a safe out-of-range sentinel for
        ``mode="drop"`` scatters and clipped gathers).
      count: scalar int32 — total set positions (may exceed K; callers
        flag overflow when count > K).
    """
    n = mask.shape[0]
    # inclusive prefix count (exact: f32 integers < 2^24)
    cum = jnp.cumsum(mask.astype(jnp.float32))
    count = cum[-1].astype(I32)

    def part(lo_slot: int, n_slots: int):
        slots = lo_slot + jnp.arange(n_slots, dtype=I32)
        # two-level bisect: a ≤104-entry strided subsample of cum gathers
        # as vectorized selects, cutting the gathered rounds from
        # log2(N) to log2(block) (ops/random.py:searchsorted_compact)
        buf = searchsorted_compact(cum, (slots + 1).astype(jnp.float32),
                                   side="left")
        used = slots < jnp.minimum(count, capacity)
        return jnp.where(used, buf, n)

    kh = min(head, capacity)
    parts = [part(0, kh)]
    lo = kh
    while lo < capacity:
        seg = min(lo * 3, capacity) - lo   # tiers: head, 3·head, 9·head, …
        parts.append(jax.lax.cond(
            count > lo, lambda _, lo=lo, seg=seg: part(lo, seg),
            lambda _: jnp.full(seg, n, I32), 0))
        lo += seg
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts), count
