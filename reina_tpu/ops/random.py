"""While-loop-free random samplers with fixed rejection rounds.

``jax.random.gamma``/``binomial`` use rejection loops built on
``lax.while_loop`` with data-dependent trip counts. These samplers run
a FIXED number of rejection rounds instead, so the surrounding program
has a static schedule. Acceptance per round is high (≳86-99%), so
the probability that any lane exhausts its rounds is negligible;
exhausted lanes fall back to a clamped moment-matched value, a bias far
below sampling noise.

The fixed rounds execute under ``lax.scan`` (static trip count — no
dynamic while): an unrolled BTRS round costs ~200 jaxpr equations and
the day step needs dozens of sampler instances, which blew the full
program past 35k equations and XLA compile past 10 minutes; scanning
the rounds keeps each sampler at one body.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax

F32 = jnp.float32


def gamma_fixed(key, kappa: float, shape, rounds: int = 4):
    """Standard Gamma(kappa) for kappa > 1 via Marsaglia–Tsang squeeze
    with ``rounds`` rejection rounds (acceptance ≈ 96-99% per round;
    P(all 4 fail) ≤ 3e-6, falling back to the mean — bias far below
    sampling noise).

    Returns float32 array of ``shape``.
    """
    assert kappa > 1.0, "gamma_fixed requires kappa > 1"
    d = kappa - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    def body(carry, k):
        out, done = carry
        kx, ku = jr.split(k)
        x = jr.normal(kx, shape, F32)
        v = (1.0 + c * x) ** 3
        u = jr.uniform(ku, shape, F32, minval=1e-37)
        ok = (v > 0) & (jnp.log(u) < 0.5 * x * x + d - d * v
                        + d * jnp.log(jnp.maximum(v, 1e-37)))
        take = ok & ~done
        return (jnp.where(take, d * v, out), done | ok), None

    init = (jnp.full(shape, jnp.nan, F32), jnp.zeros(shape, bool))
    # fully unrolled: the body is pure elementwise, so the rounds fuse
    # into one kernel instead of paying a scan iteration per round;
    # compile cost is ~25 eqns/round
    (out, done), _ = lax.scan(body, init, jr.split(key, rounds),
                              unroll=rounds)
    # fallback: mean of the distribution (P(reach) < 1e-8 for rounds=8)
    return jnp.where(done, out, kappa).astype(F32)


def _binomial_inversion(key, n, p, max_count: int = 48):
    """Binomial via CDF inversion with a fixed scan horizon —
    exact for counts < max_count, clamped above (use when n·p ≲ 10:
    P(X ≥ 48 | mean ≤ 10) < 1e-18)."""
    n = n.astype(F32)
    p = jnp.clip(p.astype(F32), 0.0, 1.0)
    u = jr.uniform(key, n.shape, F32)
    # pmf recurrence: f(0) = (1-p)^n; f(k+1) = f(k)·(n-k)/(k+1)·p/(1-p)
    q = jnp.maximum(1.0 - p, 1e-37)
    f = jnp.exp(n * jnp.log(q))
    ratio = p / q

    def body(carry, k):
        f, cdf, count, settled = carry
        f = jnp.maximum(f * (n - k) / (k + 1.0) * ratio, 0.0)
        cdf = cdf + f
        newly = ~settled & (u < cdf)
        count = jnp.where(newly, k + 1.0, count)
        return (f, cdf, count, settled | newly), None

    init = (f, f, jnp.zeros(n.shape, F32), u < f)
    # unrolled: pure elementwise rounds over small arrays fuse into a
    # handful of kernels instead of paying per-iteration scan overhead
    (_, _, count, settled), _ = lax.scan(
        body, init, jnp.arange(max_count, dtype=F32), unroll=max_count)
    return jnp.where(settled, count, jnp.minimum(n, max_count))


def _binomial_btrs(key, n, p, rounds: int = 6):
    """Binomial via the BTRS transformed-rejection sampler
    (Hörmann 1993) with fixed unrolled rounds; requires n·p ≥ 10 and
    p ≤ 0.5 (callers flip). Acceptance per round ≈ 86-99%."""
    n = n.astype(F32)
    p = jnp.clip(p.astype(F32), 1e-9, 0.5)
    q = 1.0 - p
    spq = jnp.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c_ = n * p + 0.5
    v_r = 0.92 - 4.2 / b
    log_r = jnp.log(p) - jnp.log(q)
    alpha = (2.83 + 5.1 / b) * spq
    m = jnp.floor((n + 1.0) * p)

    def fc(x):
        # Stirling correction: lgamma(x+1) = .5·log(2π) + L(x),
        # L(x) = (x+.5)·log(x) − x + fc(x)
        return 1.0 / (12.0 * x) - 1.0 / (360.0 * x ** 3)

    def log_pmf_ratio(k):
        """log f(k) − log f(m), computed cancellation-free: the large
        Stirling terms are paired via log1p of small deltas so f32
        suffices at n ~ 10^6 (naive lgamma differences lose ~0.1)."""
        d = k - m
        # part1 = L(m) − L(k) with k = m + d:
        #       = −[(m+.5)·log1p(d/m) + d·log(k) − d + fc(k) − fc(m)]
        k_s = jnp.maximum(k, 0.5)
        part1 = -((m + 0.5) * jnp.log1p(d / m) + d * jnp.log(k_s)
                  - d + fc(jnp.maximum(k, 1.0)) - fc(m))
        # k == 0 exactly: L(m) − L(0). By the defining identity
        # lgamma(x+1) = .5·log(2π) + L(x), L(0) = lgamma(1) − .5·log(2π)
        # = −0.9189385 (the Stirling FORM of L diverges at 0; only the
        # identity value is consistent with the other branch).
        part1 = jnp.where(k < 0.5,
                          (m + 0.5) * jnp.log(m) - m + fc(m) + 0.9189385,
                          part1)
        # part2 = L(n−m) − L(n−k) with a = n−k, b = n−m = a+d:
        #        = (a+.5)·log1p(d/a) + d·log(b) − d + fc(b) − fc(a)
        a_ = jnp.maximum(n - k, 0.5)
        b_ = jnp.maximum(n - m, 1.0)
        part2 = ((a_ + 0.5) * jnp.log1p(d / a_) + d * jnp.log(b_)
                 - d + fc(b_) - fc(jnp.maximum(n - k, 1.0)))
        return d * log_r + part1 + part2

    def body(carry, rk):
        out, done = carry
        ku, kv = jr.split(rk)
        u = jr.uniform(ku, n.shape, F32) - 0.5
        v = jr.uniform(kv, n.shape, F32, minval=1e-37)
        us = 0.5 - jnp.abs(u)
        k = jnp.floor((2.0 * a / us + b) * u + c_)
        in_range = (k >= 0) & (k <= n)
        k_c = jnp.clip(k, 0.0, n)
        # squeeze region: accept without evaluating the pmf
        easy = (us >= 0.07) & (v <= v_r)
        # full test: log(v·alpha/(a/us²+b)) ≤ log f(k) − log f(m)
        v2 = jnp.log(v * alpha / (a / (us * us) + b))
        accept = in_range & (easy | (v2 <= log_pmf_ratio(k_c)))
        take = accept & ~done
        return (jnp.where(take, k_c, out), done | accept), None

    init = (jnp.full(n.shape, jnp.nan, F32), jnp.zeros(n.shape, bool))
    (out, done), _ = lax.scan(body, init, jr.split(key, rounds),
                              unroll=rounds)
    return jnp.where(done, out, jnp.round(n * p))


def binomial_fixed(key, n, p, rounds: int = 6):
    """Binomial(n, p) sampler, while-free. Exact inversion for
    n·p ≤ 10, BTRS rejection otherwise; handles p > 0.5 by flipping."""
    n = jnp.asarray(n, F32)
    p = jnp.clip(jnp.asarray(p, F32), 0.0, 1.0)
    flip = p > 0.5
    p_eff = jnp.where(flip, 1.0 - p, p)
    mean = n * p_eff
    k_inv, k_btrs = jr.split(key)
    small = _binomial_inversion(k_inv, n, jnp.where(mean <= 10.0, p_eff, 0.0))
    big = _binomial_btrs(k_btrs, jnp.where(mean > 10.0, n, 100.0),
                         jnp.where(mean > 10.0, p_eff, 0.2))
    cnt = jnp.where(mean <= 10.0, small, big)
    cnt = jnp.clip(cnt, 0.0, n)
    return jnp.where(flip, n - cnt, cnt)


def searchsorted_fixed(sorted_arr, queries, side: str = "left",
                       n_steps: int | None = None,
                       lo_init=None, hi_init=None,
                       max_range: int | None = None):
    """Bisect with a fixed unrolled binary search (no while ops).
    Equivalent to jnp.searchsorted(sorted_arr, queries, side=side).

    ``lo_init``/``hi_init`` restrict each query to a known bracket
    (e.g. an age-bucket range), cutting the unrolled step count to
    log2(max_range) — every step is a gather op."""
    n = sorted_arr.shape[0]
    if n_steps is None:
        n_steps = (max_range if max_range is not None else n).bit_length()
    lo = (jnp.zeros(queries.shape, jnp.int32) if lo_init is None
          else lo_init.astype(jnp.int32))
    hi = (jnp.full(queries.shape, n, jnp.int32) if hi_init is None
          else hi_init.astype(jnp.int32))

    def body(carry, _):
        lo, hi = carry
        active = lo < hi
        mid = (lo + hi) // 2
        vals = sorted_arr[jnp.clip(mid, 0, n - 1)]
        go_right = (vals < queries) if side == "left" else (vals <= queries)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return (lo, hi), None

    # partial unroll, but keep the while alive: rounds INSIDE a while
    # keep the lo/hi state resident, where top-level rounds would
    # re-read/write the query-state arrays. XLA may FULLY UNROLL a while
    # with trip count 2, and a peeled scan remainder materializes too —
    # so pick the largest unroll ≤ 7 with ≥ 3 trips, padding n_steps to
    # a multiple (extra rounds are no-ops once lo == hi, just their
    # gather cost; minimized by the search).
    if n_steps > 7:
        # cost model: a while trip and a round cost about the same —
        # minimize trips + padded rounds
        def cost(u):
            trips = max(3, -(-n_steps // u))
            return trips + trips * u, -u
        unroll = min(range(1, 8), key=cost)
        n_steps = unroll * max(3, -(-n_steps // unroll))
    else:
        unroll = n_steps
    (lo, hi), _ = lax.scan(body, (lo, hi), None, length=n_steps,
                           unroll=unroll)
    return lo


def tiny_level1_block(n: int, max_sub: int = 104):
    """Smallest ``block`` with ``n % block == 0`` whose strided
    subsample ``arr[block-1::block]`` still has ≤ max_sub entries — the
    level-1 table stays ≤~100 entries (gathers as vectorized selects)
    while minimizing the
    log2(block) *gathered* level-2 rounds. Returns None when n has no
    such divisor (prime-ish n) or the saving would be < 4 rounds."""
    for k in range(max_sub, 15, -1):
        if n % k == 0:
            return n // k
    return None


def searchsorted_compact(sorted_arr, queries, side: str = "left"):
    """Full-range bisect that routes through a free select-table level
    1 when the array length allows it (tiny_level1_block); otherwise a
    plain fixed bisect. Results are identical — bisection over the
    same array is exact under any bracketing path."""
    n = sorted_arr.shape[0]
    blk = tiny_level1_block(n)
    if blk is None or blk >= n:
        return searchsorted_fixed(sorted_arr, queries, side=side)
    return searchsorted_blocked(sorted_arr, queries, side=side, block=blk)


def searchsorted_blocked(sorted_arr, queries, side: str = "left",
                         block: int = 128, lo_init=None, hi_init=None):
    """Two-level bisect over a large sorted array: level 1 bisects the
    strided subsample ``sorted_arr[block-1::block]`` to locate a block,
    level 2 runs log2(block) rounds against the big array. The
    subsample shares storage values with the big array (a strided
    slice, not a recomputation), so the bracket is exact even for
    float data.

    The saving is the level-1 rounds' gathers, which read a ≤104-entry
    table instead of the big array; whether that beats a plain
    bracketed ``searchsorted_fixed`` depends on the backend's gather
    cost for small tables.

    Requires ``sorted_arr.shape[0] % block == 0``.
    """
    n = sorted_arr.shape[0]
    assert n % block == 0, (n, block)
    # materialize the subsample: without the barrier XLA fuses the
    # strided slice into the level-1 gathers, which then read the BIG
    # array instead of a ≤104-entry table
    cum_b = jax.lax.optimization_barrier(sorted_arr[block - 1::block])
    blk_lo = None if lo_init is None else lo_init // block
    blk_hi = None if hi_init is None else (hi_init + block - 1) // block
    blk = searchsorted_fixed(cum_b, queries, side=side,
                             lo_init=blk_lo, hi_init=blk_hi)
    lo = blk * block
    hi = jnp.minimum(lo + block, n)
    if lo_init is not None:
        lo = jnp.maximum(lo, lo_init.astype(jnp.int32))
    if hi_init is not None:
        hi = jnp.minimum(hi, hi_init.astype(jnp.int32))
    return searchsorted_fixed(sorted_arr, queries, side=side,
                              lo_init=lo, hi_init=hi, max_range=block)
