"""Ensemble vmap + multi-chip mesh sharding (8 virtual CPU devices).

Every whole-engine-compiling test here runs in its OWN fresh child
interpreter (test_parallel_isolated, parametrized per test): the
cumulative XLA:CPU defect (tests/_isolation.py) SIGABRTs a process
after ~4-6 whole-engine compiles — a single whole-module child
accumulated ~6 and died even though the same test passes alone. Per-test
children keep every child ≤ ~3 big compiles; the persistent CPU
compile cache (conftest) serves repeated programs across children, so
the split costs only interpreter startup for the cache-served tests.
"""
import numpy as np
import pytest

import jax

from _isolation import ISOLATED, run_isolated

needs_fresh_process = pytest.mark.skipif(
    not ISOLATED,
    reason="compile-fragile: executed inside test_parallel_isolated's "
           "child interpreter")

# every @needs_fresh_process test below, launched one child each
GUARDED_TESTS = [
    "test_ensemble_vmap",
    "test_ensemble_matches_single",
    "test_dryrun_multichip",
    "test_dryrun_multichip_agent8",
    "test_sharded_ensemble",
    "test_sharded_ensemble_seed_only_8",
    "test_run_days_agent_sharded",
    "test_run_days_agent_sharded_8_fallback",
    "test_mesh_checkpoint_resume",
    "test_ensemble_single_seed_bypass",
    "test_ensemble_64_seed_batch",
]


@pytest.mark.parametrize("node", GUARDED_TESTS)
def test_parallel_isolated(node):
    """Run each guarded test below in its own fresh interpreter."""
    if ISOLATED:
        pytest.skip("already inside the isolated child")
    run_isolated(f"tests/test_parallel.py::{node}")


@needs_fresh_process
def test_ensemble_vmap(tiny_run):
    from reina_tpu.ensemble import run_ensemble
    outs = run_ensemble(tiny_run, seeds=[1, 2, 3], batch_size=3, n_days=12)
    assert outs.by_group.shape[:2] == (3, 11)
    final = outs.by_group[:, -1, 3].sum(axis=1)  # all_infected per seed
    assert (final > 0).all()
    # different seeds → different trajectories
    assert len(set(final.tolist())) > 1


@needs_fresh_process
def test_ensemble_matches_single(tiny_run):
    """A vmapped member equals the single-run path with the same seed."""
    from reina_tpu.core.engine import run_days
    from reina_tpu.ensemble import run_ensemble
    single, _, _, _ = run_days(tiny_run, n_days=10, chunk_days=9,
                               seed=42)
    batch = run_ensemble(tiny_run, seeds=[42], batch_size=1, n_days=10)
    np.testing.assert_array_equal(single.by_group[1:], batch.by_group[0])


@needs_fresh_process
def test_dryrun_multichip():
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@needs_fresh_process
def test_sharded_ensemble(tiny_run):
    from reina_tpu.ensemble import run_ensemble
    from reina_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(n_seed=2, n_agent=4)
    outs = run_ensemble(tiny_run, seeds=[5, 6], batch_size=2, mesh=mesh,
                        n_days=8)
    assert outs.by_group.shape[:2] == (2, 7)
    assert outs.by_group[:, -1, 3].sum() > 0


@needs_fresh_process
def test_run_days_agent_sharded(tiny_run):
    """A full single-run simulation sharded over the mesh's agent axis
    matches the unsharded run exactly (same counter-based RNG)."""
    from reina_tpu.core.engine import run_days
    from reina_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_seed=1, n_agent=4, devices=jax.devices()[:4])
    out_sharded, _, _, _ = run_days(tiny_run, n_days=13, chunk_days=6,
                                    mesh=mesh)
    out_plain, _, _, _ = run_days(tiny_run, n_days=13, chunk_days=6)
    np.testing.assert_array_equal(out_sharded.by_group, out_plain.by_group)
    np.testing.assert_array_equal(out_sharded.available_icu_units,
                                  out_plain.available_icu_units)


@needs_fresh_process
def test_run_days_agent_sharded_8_fallback(tiny_run):
    """Agent-only 1×8 mesh: tiny_run's N (20224) splits into 8 shards of
    2528 agents (not a multiple of 1024) — the GSPMD-partitioned run is
    still bit-identical to the unsharded run."""
    from reina_tpu.core.engine import run_days
    from reina_tpu.parallel.mesh import make_mesh

    n = tiny_run.init_state.age.shape[0]
    assert n % 8 == 0 and n % (8 * 1024) != 0, n
    mesh = make_mesh(n_seed=1, n_agent=8)
    # n_days=13 → 12 steps = 2×6: no remainder chunk (each distinct
    # chunk_len compiles its own program — expensive on the 1-core CI)
    out_sharded, _, _, _ = run_days(tiny_run, n_days=13, chunk_days=6,
                                    mesh=mesh)
    out_plain, _, _, _ = run_days(tiny_run, n_days=13, chunk_days=6)
    np.testing.assert_array_equal(out_sharded.by_group, out_plain.by_group)
    np.testing.assert_array_equal(out_sharded.r, out_plain.r)


@needs_fresh_process
def test_sharded_ensemble_seed_only_8(tiny_run):
    """Seed-only 8×1 mesh: 8 ensemble members, one per device, no agent
    sharding — the pure data-parallel Monte-Carlo layout."""
    from reina_tpu.ensemble import run_ensemble
    from reina_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_seed=8, n_agent=1)
    outs = run_ensemble(tiny_run, seeds=list(range(8)), batch_size=8,
                        mesh=mesh, n_days=8)
    assert outs.by_group.shape[:2] == (8, 7)
    finals = outs.by_group[:, -1, 3].sum(axis=1)
    assert (finals > 0).all()
    assert len(set(finals.tolist())) > 1


@needs_fresh_process
def test_dryrun_multichip_agent8():
    """The driver dryrun at FULL agent sharding (1 seed × 8 agent
    shards)."""
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry_a8",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8, n_agent=8)


@needs_fresh_process
def test_mesh_checkpoint_resume(tiny_run, tmp_path):
    """Checkpoint a SHARDED run mid-flight, resume with mesh= set —
    bit-identical to the uninterrupted sharded run. Executes the
    place_state_carry resume path (core/engine.py resume branch)."""
    from reina_tpu.core.engine import run_days
    from reina_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_seed=1, n_agent=4, devices=jax.devices()[:4])
    full, state_a, carry_a, _ = run_days(tiny_run, n_days=13, chunk_days=6,
                                         mesh=mesh)
    ckpt = tmp_path / "ckpts"
    run_days(tiny_run, n_days=7, chunk_days=6, mesh=mesh,
             checkpoint_dir=str(ckpt), checkpoint_every=6)
    import os
    assert os.listdir(ckpt)
    out2, state_b, carry_b, _ = run_days(
        tiny_run, n_days=13, chunk_days=6, mesh=mesh,
        checkpoint_dir=str(ckpt), checkpoint_every=6)
    np.testing.assert_array_equal(full.by_group, out2.by_group)
    np.testing.assert_array_equal(full.r, out2.r)
    np.testing.assert_array_equal(np.asarray(state_a.state),
                                  np.asarray(state_b.state))
    np.testing.assert_array_equal(np.asarray(state_a.infector),
                                  np.asarray(state_b.infector))
    assert int(carry_a.beds_avail) == int(carry_b.beds_avail)


@needs_fresh_process
def test_ensemble_single_seed_bypass(tiny_run):
    """batch remainder of 1 routes through the plain (non-vmapped) scan
    and matches the vmapped result shape-wise."""
    from reina_tpu.ensemble import run_ensemble

    outs = run_ensemble(tiny_run, seeds=[5, 6, 7], batch_size=2,
                        n_days=9)
    assert outs.by_group.shape[0] == 3
    assert outs.by_group.shape[1] == 8
    assert (outs.by_group >= 0).all()


@needs_fresh_process
def test_ensemble_64_seed_batch():
    """A reference-scale seed batch (64 vmapped seeds in one XLA
    program) runs and every member stays problem-free with plausible,
    seed-distinct trajectories (judge workload: 1000-seed Monte-Carlo,
    reference calc/simulation.py:349-385)."""
    from reina_tpu.ensemble import run_ensemble
    from reina_tpu.testing import build_synthetic_run

    run = build_synthetic_run(
        n_agents=4000, days=8, seed=0,
        interventions=[["import-infections", "2020-02-19", 30]],
        pad_multiple=256)
    outs = run_ensemble(run, seeds=list(range(64)), batch_size=64,
                        n_days=8)
    infected = outs.by_group[:, :, 3, :].sum(axis=-1)   # (64, days)
    assert infected.shape[0] == 64
    finals = infected[:, -1]
    assert (finals >= 30).all()             # imports took hold everywhere
    assert len(np.unique(finals)) > 10      # seeds genuinely differ


def test_init_distributed_single_process_noop(monkeypatch):
    """Without a coordinator configured, multi-host init is a no-op."""
    from reina_tpu.parallel.mesh import init_distributed
    monkeypatch.delenv("REINA_COORDINATOR", raising=False)
    assert init_distributed() == 1


def test_fi_catalog_covers_reference_msgids():
    """The Finnish catalog covers the exact msgid SET of the reference's
    messages.po (139 unique non-header msgids;
    /root/reference/locale/fi/LC_MESSAGES/messages.po) — a count-only
    assertion would pass a wrong-key regression."""
    from reina_tpu.utils.locale import REFERENCE_MSGIDS, TRANSLATIONS
    missing = set(REFERENCE_MSGIDS) - set(TRANSLATIONS["fi"])
    assert not missing, f"fi catalog missing reference msgids: {missing}"
    assert len(REFERENCE_MSGIDS) >= 139
