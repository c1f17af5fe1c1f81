"""Deliberate exercise of the infection-slot TAIL tiers.

With the default ``infection_head`` (1024 slots) the CPU suite's small
populations never see more daily infections than the head, so
``compact_part`` tail tiers, ``slot_pipeline`` parts >= 1, the geometric
tail scatters and the per-tier key schedule (core/step.py slot
pipeline) — the code every real HUS epidemic-peak day runs — were
exercised only by full-size runs. A tiny head forces multiple tiers and
tail scatters on every epidemic day. Reference behavior anchored at
main.pyx:209-245 (person_infect runs per new infection regardless of
the day's count; the tiering must be invisible).

Head size is a documented re-keying (docs/parity.md: per-tier fold_in
keys), so tiny-head vs default-head runs are compared in distribution
across seeds, not bit-for-bit.
"""
import numpy as np
import pytest

from _isolation import ISOLATED, run_isolated

from reina_tpu.core.engine import run_days
from reina_tpu.testing import build_synthetic_run

needs_fresh_process = pytest.mark.skipif(
    not ISOLATED,
    reason="compile-fragile: three fresh whole-engine compiles — the "
           "cumulative XLA:CPU defect (tests/_isolation.py) segfaulted "
           "at this module's first cache write on a cold cache")


def test_tail_tiers_isolated():
    """Run the guarded tests below in a fresh interpreter."""
    if ISOLATED:
        pytest.skip("already inside the isolated child")
    run_isolated("tests/test_tail_tiers.py")

IVS = [
    ["import-infections", "2020-02-18", 120],
    ["import-infections", "2020-02-20", 80],
    ["test-all-with-symptoms", "2020-02-18"],
]

# head 16 with a 4096 buffer → tiers (0,16),(16,32),(48,96),(144,288),
# (432,864),(1296,2592),(3888,208): the 120-import day engages three
# tiers, epidemic days two or more
TINY = {"infection_head": 16, "infection_buffer": 4096}
N_AGENTS = 8000
DAYS = 15


def _run(seed, cfg_overrides=None, chunk_days=7):
    run = build_synthetic_run(
        n_agents=N_AGENTS, days=DAYS, seed=seed, interventions=IVS,
        pad_multiple=256, cfg_overrides=cfg_overrides)
    return run_days(run, chunk_days=chunk_days, seed=seed)


def test_tail_tiers_engaged_and_conserving():
    out, state, carry, _ = _run(7, TINY)
    assert int(carry.problem) == 0
    # the tiny head was genuinely exceeded (tail tiers + tail scatters
    # executed), otherwise this test proves nothing
    new_inf = out.by_group[:, 12].sum(axis=1)
    assert new_inf.max() > TINY["infection_head"], new_inf
    assert (new_inf > TINY["infection_head"]).sum() >= 3
    # conservation invariants survive tiered compaction/scatters
    susceptible = out.by_group[:, 0].sum(axis=1)
    all_infected = out.by_group[:, 3].sum(axis=1)
    np.testing.assert_array_equal(susceptible + all_infected, N_AGENTS)
    dead = out.by_group[:, 9].sum(axis=1)
    recovered = out.by_group[:, 10].sum(axis=1)
    infected = out.by_group[:, 2].sum(axis=1)
    np.testing.assert_array_equal(dead + recovered + infected, all_infected)
    # every new infection got a real severity/duration draw: infected
    # agents must progress (illness onset happened → days_left set)
    assert all_infected[-1] > 150


def test_tail_tiers_deterministic_across_chunking():
    """Tier math is day-local: chunk boundaries can't change it."""
    # 14 steps = 2×7 = 7×2: both chunkings divide exactly, so the
    # comparison costs ONE extra compiled program (chunk 2), not two
    # (a remainder chunk compiles its own chunk_len program)
    out1, _, _, _ = _run(7, TINY, chunk_days=7)
    out2, _, _, _ = _run(7, TINY, chunk_days=2)
    np.testing.assert_array_equal(out1.by_group, out2.by_group)
    np.testing.assert_array_equal(out1.infected_by_variant,
                                  out2.infected_by_variant)


def test_tiny_head_matches_default_head_in_distribution():
    """The head size must not shift the epidemic, only re-key it
    (docs/parity.md): seed-averaged final cumulative infections agree
    within mean ± 4·SE + 10%."""
    seeds = range(100, 108)
    finals_tiny, finals_def = [], []
    for s in seeds:
        out_t, _, carry_t, _ = _run(s, TINY)
        assert int(carry_t.problem) == 0
        finals_tiny.append(out_t.by_group[-1, 3].sum())
        out_d, _, carry_d, _ = _run(s)
        assert int(carry_d.problem) == 0
        finals_def.append(out_d.by_group[-1, 3].sum())
    t = np.array(finals_tiny, float)
    d = np.array(finals_def, float)
    se = np.hypot(t.std(ddof=1) / np.sqrt(len(t)),
                  d.std(ddof=1) / np.sqrt(len(d)))
    tol = 4 * se + 0.10 * max(d.mean(), 10)
    assert abs(t.mean() - d.mean()) <= tol, (
        f"tiny-head {t.mean():.1f} vs default {d.mean():.1f} (tol {tol:.1f})")
