"""Clamped-counter prefix scan: exact sequential scarce-resource semantics
with parallel prefix primitives.

The reference engine hands out hospital beds / ICU units first-come-
first-served while sweeping agents in cyclic order from a random start
offset (main.pyx:617-648, 1982-1992): at each position a *release*
returns a unit (counter += 1) and a *request* is granted iff the
counter is positive (counter -= 1, floored at 0).

The sequential automaton is b_i = max(b_{i-1} + a_i, m_i) — a
composition of max-plus affine maps f(x) = max(x + a, m). Composing
f_0 … f_{i-1} onto the initial balance has the closed form

    arriving_i = S⁻_i + max(init, max_{j<i}(m_j − S_j))

with S the inclusive prefix sum of a and S⁻ its exclusive version —
i.e. one ``cumsum`` plus one ``cummax``.

The cyclic sweep order is handled without any rotation: positions are
split into the segments [offset, N) and [0, offset); events outside a
segment become identities (a=0, m=−∞), which are also the identities of
cumsum/cummax, so each segment is a masked prefix over the *original*
order and the second segment starts from the first segment's final
balance.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_NEG = -(1 << 30)  # python int: keeps the module free of device arrays


def clamped_counter_grants(releases, requests, init, offset):
    """Grant/deny requests against a clamped counter in cyclic sweep order.

    Args:
      releases: (N,) int32 — units returned at each position (>= 0).
      requests: (N,) bool — whether the agent requests one unit.
      init: scalar int32 — counter value at sweep start.
      offset: scalar int32 — sweep starts at position ``offset`` and
        wraps (the reference's random start index, main.pyx:1988).

    Several independent counters (hospital beds, ICU units) run as a
    LIST (or tuple) of L (N,) release/request columns with (L,) init;
    each ledger runs its own 1-D cumulative passes over flat columns.
    An (N, L) array is also accepted and split into columns.

    The cyclic wrap ([offset, N) then [0, offset)) needs NO masked
    cumsum lanes: segment-local prefix *sums* fall out of the one
    unmasked cumsum by subtracting the scalar prefix at ``offset``
    (max(x+c, y+c) = max(x, y)+c moves the correction outside the
    cummax), and for positions i < offset the unmasked running max
    already equals segment b's (every j < i is in segment b). Only
    segment a needs its own masked cummax — 1 cumsum + 2 cummax 1-D
    passes per ledger.

    Returns:
      granted: (N,) bool — or a TUPLE of L (N,) bools for multi-ledger
        input — request approved (counter was > 0 on arrival, counting
        the position's own release first).
      final: scalar or (L,) int32 — counter value after the full sweep.
    """
    init = jnp.asarray(init, jnp.int32)
    if isinstance(releases, (list, tuple)):
        rel_cols = [r.astype(jnp.int32) for r in releases]
        req_cols = list(requests)
        squeeze = False
    else:
        releases = releases.astype(jnp.int32)
        squeeze = releases.ndim == 1
        if squeeze:
            rel_cols, req_cols = [releases], [requests]
            init = init.reshape(init.shape or (1,)) if init.ndim == 0 \
                else init[..., None]
        else:
            rel_cols = [releases[:, j] for j in range(releases.shape[1])]
            req_cols = [requests[:, j] for j in range(requests.shape[1])]
    n = rel_cols[0].shape[0]
    L = len(rel_cols)

    def _out(granted, final):
        if squeeze:
            return granted[0], final[0]
        if isinstance(releases, (list, tuple)):
            return tuple(granted), final
        return jnp.stack(granted, axis=1), final

    idx = jnp.arange(n, dtype=jnp.int32)
    in_a = idx >= offset
    pad1 = jnp.full((1,), _NEG, jnp.int32)

    granted_cols = []
    finals = []
    for led in range(L):
        rel = rel_cols[led]
        req = req_cols[led]
        a = rel - req.astype(jnp.int32)
        m = jnp.where(req, 0, _NEG)

        s_incl = jnp.cumsum(a)
        s_excl = s_incl - a
        c_off = s_excl[offset]            # prefix sum entering segment a

        key = m - s_incl                  # segment-b keys (unmasked)
        key_a = jnp.where(in_a, key, _NEG)
        rm_a = lax.cummax(key_a)
        rm_f = lax.cummax(key)
        rm_a_excl = jnp.concatenate([pad1, rm_a[:-1]])
        rm_f_excl = jnp.concatenate([pad1, rm_f[:-1]])

        base_a = init[led] - c_off
        final_a = s_incl[-1] + jnp.maximum(base_a, rm_a[-1])
        arriving_a = s_excl + jnp.maximum(base_a, rm_a_excl)
        arriving_b = s_excl + jnp.maximum(final_a, rm_f_excl)
        # segment b's closing balance: its total is c_off, its running
        # max is the unmasked prefix max just before ``offset``
        final_b = c_off + jnp.maximum(final_a, rm_f_excl[offset])

        arriving = jnp.where(in_a, arriving_a, arriving_b)
        granted_cols.append(req & ((arriving + rel) > 0))
        finals.append(final_b)

    return _out(granted_cols, jnp.stack(finals))
