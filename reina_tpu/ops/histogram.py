"""Exact-integer histograms over the agent axis.

Both forms count into a handful of small bins (output age groups, ages,
dart groups) and return float32 sums of exact integers, which are exact
under any summation order while every column total stays below 2^24.
Codes outside ``[0, n)`` contribute nothing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_counts(parts, code_b, n_b: int):
    """out[k, b] = sum_i parts[k][i] * [code_b[i] == b].

    ``parts``: K same-length (N,) arrays of values exact in bfloat16
    (masks, small counts). One (K, N) x (N, n_b) dot with bfloat16
    operands and float32 accumulation: every product is exact, so the
    float32 sums are exact integers. Returns (K, n_b) float32."""
    lhs = jnp.stack([p.astype(jnp.bfloat16) for p in parts], axis=0)
    iota = jax.lax.broadcasted_iota(jnp.int32, (code_b.shape[0], n_b), 1)
    onehot = (code_b.astype(jnp.int32)[:, None] == iota).astype(jnp.bfloat16)
    return jax.lax.dot_general(lhs, onehot, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def bihistogram(code_a, n_a: int, weights, code_b, n_b: int):
    """out[a, b] = sum_i weights[i] * [code_a[i] == a] * [code_b[i] == b]
    as one scatter-add into the flattened (n_a * n_b) bins. ``weights``
    are exact integers (the engine's contact counts, <= 128). Returns
    (n_a, n_b) float32."""
    code_a = code_a.astype(jnp.int32)
    code_b = code_b.astype(jnp.int32)
    ok = (code_a >= 0) & (code_a < n_a) & (code_b >= 0) & (code_b < n_b)
    bins = jnp.where(ok, code_a * n_b + code_b, n_a * n_b)
    flat = jax.ops.segment_sum(weights.astype(jnp.float32), bins,
                               num_segments=n_a * n_b + 1)
    return flat[:-1].reshape(n_a, n_b)
