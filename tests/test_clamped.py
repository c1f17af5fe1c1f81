"""The clamped-counter scan must match a literal sequential sweep."""
import numpy as np
import jax.numpy as jnp

from reina_tpu.ops.clamped import clamped_counter_grants


def sequential(releases, requests, init, offset):
    n = len(releases)
    bal = init
    granted = np.zeros(n, dtype=bool)
    for i in range(n):
        p = (offset + i) % n
        bal += releases[p]
        if requests[p]:
            if bal > 0:
                bal -= 1
                granted[p] = True
    return granted, bal


def test_matches_sequential_semantics():
    rng = np.random.default_rng(0)
    for trial in range(30):
        n = int(rng.integers(3, 200))
        releases = rng.integers(0, 2, n)
        requests = rng.random(n) < 0.4
        init = int(rng.integers(0, 5))
        offset = int(rng.integers(0, n))
        want_g, want_b = sequential(releases, requests, init, offset)
        got_g, got_b = clamped_counter_grants(
            jnp.asarray(releases, jnp.int32), jnp.asarray(requests),
            jnp.int32(init), jnp.int32(offset))
        np.testing.assert_array_equal(np.asarray(got_g), want_g,
                                      err_msg=f"trial {trial}")
        assert int(got_b) == want_b, trial


def test_scarcity_grants_exactly_available():
    n = 64
    requests = np.ones(n, dtype=bool)
    releases = np.zeros(n, dtype=np.int32)
    granted, bal = clamped_counter_grants(
        jnp.asarray(releases), jnp.asarray(requests), jnp.int32(10),
        jnp.int32(17))
    g = np.asarray(granted)
    assert g.sum() == 10
    assert int(bal) == 0
    # the granted arc starts at the sweep offset
    assert g[17] and g[(17 + 9) % n] and not g[(17 + 10) % n]


def test_two_ledger_batch_matches_sequential():
    """The (N, L) multi-ledger path (beds + ICU ride one call in the
    engine) matches per-ledger sequential sweeps."""
    rng = np.random.default_rng(7)
    for trial in range(10):
        n = int(rng.integers(5, 150))
        releases = rng.integers(0, 2, (n, 2)).astype(np.int32)
        requests = rng.random((n, 2)) < 0.5
        init = rng.integers(0, 4, 2).astype(np.int32)
        offset = int(rng.integers(0, n))
        got_g, got_b = clamped_counter_grants(
            jnp.asarray(releases), jnp.asarray(requests),
            jnp.asarray(init), jnp.int32(offset))
        for led in range(2):
            want_g, want_b = sequential(releases[:, led], requests[:, led],
                                        int(init[led]), offset)
            np.testing.assert_array_equal(np.asarray(got_g)[:, led], want_g,
                                          err_msg=f"trial {trial} led {led}")
            assert int(np.asarray(got_b)[led]) == want_b, (trial, led)
