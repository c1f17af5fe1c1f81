"""Run assembly and execution: variables → compiled run → scanned days.

``build_run`` compiles everything the scanned day step needs (model
arrays, intervention schedules, seeded agent state); ``run_days``
executes a jitted ``lax.scan`` over day chunks so the host can stream
partial results between chunks (the reference streams per-day rows to a
cache from its worker process, simulation_thread.py:38-46).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from . import constants as C
from .params import (compile_disease, compile_import_ages,
                     compile_population, create_disease_params)
from .schedule import Schedules, compile_schedules
from .state import (AgentState, DayCarry, blank_state, initial_all_detected,
                    seed_initial_state)
from .step import EngineConfig, ModelArrays, SchedRow, day_step, \
    snapshot_outputs
from ..config.interventions import get_active_interventions
from ..data import loaders


@dataclass
class CompiledRun:
    cfg: EngineConfig
    arrays: ModelArrays
    schedules: Schedules          # device arrays, leading axis = days
    init_state: AgentState
    init_carry: DayCarry
    days: int
    start_date: str
    random_seed: int
    variant_names: List[str]
    group_labels: List[str]
    n_agents: int
    meta: Dict[str, Any] = field(default_factory=dict)


def build_run(variables: Dict[str, Any],
              cfg_overrides: Optional[Dict[str, Any]] = None,
              age_counts_override: Optional[np.ndarray] = None,
              pad_multiple: int = 1024) -> CompiledRun:
    """Compile a full simulation from resolved variables
    (the analog of constructing model.Context, main.pyx:1759-1781).

    ``age_counts_override`` swaps in a synthetic population (tests,
    multi-chip dry runs) without touching the dataset layer."""
    nr_ages = variables["max_age"] + 1
    days = variables["simulation_days"]
    seed = variables["random_seed"]

    if age_counts_override is not None:
        age_counts = np.asarray(age_counts_override)[:nr_ages]
    else:
        age_counts = loaders.get_population_for_area(variables["area_name"])[:nr_ages]
    contacts = loaders.get_contact_tensor()
    band_of_age = contacts.band_of_age(variables["max_age"])
    contact_base = contacts.per_year_participant(variables["max_age"]).astype(np.float32)

    disease_params = create_disease_params(variables)
    disease, variant_names = compile_disease(disease_params, nr_ages)
    V = len(variant_names)

    pop = compile_population(np.asarray(age_counts), band_of_age,
                             pad_multiple=pad_multiple)
    n_padded = len(pop.ages)

    ivs = get_active_interventions(variables)
    # at least one schedule row so the day-0 snapshot (which reads
    # schedule[0]) works for degenerate 0-day runs
    sched_np, slots = compile_schedules(
        ivs, variables["start_date"], max(days, 1), nr_ages, variant_names)

    import_ages = compile_import_ages(
        create_pairs(variables["imported_infection_ages"]), nr_ages)

    # σmax per (variant, band): receiver-side thinning bound
    B = int(band_of_age.max()) + 1
    sigma_max = np.zeros((V, B), dtype=np.float32)
    for b in range(B):
        sel = band_of_age == b
        sigma_max[:, b] = disease.p_susc[:, sel].max(axis=1)

    G = pop.nr_groups

    # Static per-agent expansions of every age/band-indexed table.
    ages_i = pop.ages.astype(np.int32)
    band_ag = band_of_age[ages_i].astype(np.int32)
    nb_ag = pop.band_counts[band_ag].astype(np.float32)
    # a band whose every age has p_susceptibility 0 has sigma_max 0;
    # guard the 0/0 (p_susc is 0 too) so the intended probability-0
    # behavior comes out instead of NaN baked into the model arrays
    smax_ag = sigma_max[:, band_ag]
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = disease.p_susc[:, ages_i] / (smax_ag * np.maximum(nb_ag, 1.0))
    lam_log1p_ag = np.log1p(
        -np.where(smax_ag > 0, lam, 0.0)).astype(np.float32)
    age_hi = ages_i // 8
    age_lo = ages_i % 8
    n_hi = (nr_ages + 7) // 8
    age_onehot_hi = jax.nn.one_hot(age_hi, n_hi, dtype=jnp.bfloat16)
    age_onehot_lo = jax.nn.one_hot(age_lo, 8, dtype=jnp.bfloat16)

    arrays = ModelArrays(
        ages=jnp.asarray(pop.ages, jnp.int32),
        active=jnp.asarray(pop.active),
        age_start=jnp.asarray(pop.age_start),
        band_of_age=jnp.asarray(pop.band_of_age),
        band_counts=jnp.asarray(pop.band_counts),
        group_of_agent=jnp.asarray(pop.group_of_agent),
        active_per_group=jnp.asarray(np.bincount(
            np.asarray(pop.group_of_agent)[np.asarray(pop.active)],
            minlength=G + 1)[:G].astype(np.int32)),
        contact_base=jnp.asarray(contact_base),
        p_susc=jnp.asarray(disease.p_susc),
        sigma_max=jnp.asarray(sigma_max),
        p_sympt=jnp.asarray(disease.p_sympt),
        p_severe_c=jnp.asarray(disease.p_severe_c),
        p_critical_c=jnp.asarray(disease.p_critical_c),
        p_fatal_c=jnp.asarray(disease.p_fatal_c),
        p_doh=jnp.asarray(disease.p_doh),
        band_ag=jnp.asarray(band_ag),
        lam_log1p_ag=jnp.asarray(lam_log1p_ag),
        age_onehot_hi=age_onehot_hi,
        age_onehot_lo=age_onehot_lo,
        iot=jnp.asarray(disease.iot),
        inf_mult=jnp.asarray(disease.inf_mult),
        asymp_mult=jnp.asarray(disease.asymp_mult),
        mask_pw=jnp.asarray(disease.mask_pw),
        mask_po=jnp.asarray(disease.mask_po),
        p_hosp_death_no_beds=jnp.asarray(disease.p_hosp_death_no_beds),
        p_icu_death_no_beds=jnp.asarray(disease.p_icu_death_no_beds),
        mu_incub=jnp.asarray(disease.mu_incub),
        mu_death=jnp.asarray(disease.mu_death),
        mu_recov=jnp.asarray(disease.mu_recov),
        ratio_before_hosp=jnp.asarray(disease.ratio_before_hosp),
        ratio_in_ward=jnp.asarray(disease.ratio_in_ward),
        import_cum_p=jnp.asarray(import_ages.cum_p),
        import_min_age=jnp.asarray(import_ages.min_age),
        import_max_age=jnp.asarray(import_ages.max_age),
        vacc_min_age=jnp.asarray(slots.min_age),
        vacc_max_age=jnp.asarray(slots.max_age),
    )

    # initial agent state + seeded epidemic condition
    state_np = blank_state(pop)
    ipc = loaders.get_initial_population_condition(
        variables["area_name"], variables["start_date"],
        incubating=variables["incubating_at_simulation_start"],
        ill=variables["ill_at_simulation_start"],
        recovered=variables["recovered_at_simulation_start"])
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    beds = variables["hospital_beds"]
    icu = variables["icu_units"]
    state_np, avail_beds, avail_icu = seed_initial_state(
        state_np, disease, ipc, beds, icu, rng)

    from .params import make_age_groups
    labels = make_age_groups(nr_ages - 1)
    group_of_age = np.array([pop.group_labels.index(x) for x in labels],
                            dtype=np.int32)

    max_cohort = max(int(np.asarray(age_counts).max()), 2)
    cfg = EngineConfig(
        vacc_slots=max(slots.count, 1),
        nr_variants=V,
        nr_groups=G,
        max_age_cohort=1 << (max_cohort - 1).bit_length(),
        **(cfg_overrides or {}))

    init_carry = DayCarry(
        day=jnp.int32(0),
        beds_avail=jnp.int32(avail_beds),
        icu_avail=jnp.int32(avail_icu),
        beds_total=jnp.int32(beds),
        icu_total=jnp.int32(icu),
        weekly_leftover=jnp.zeros(V, jnp.float32),
        all_detected=jnp.asarray(initial_all_detected(
            ipc.confirmed_cases, group_of_age, G, nr_ages)),
        problem=jnp.int32(0),
        bkt_dst=jnp.full(n_padded * cfg.max_infectees, n_padded,
                         jnp.int32),
        bkt_fill=jnp.zeros(n_padded, jnp.int32),
        # -1 mobility can't match any schedule row -> day 0 recomputes
        mob=jnp.full(arrays.contact_base.shape[:2], -1.0, jnp.float32),
        nc_ag=jnp.zeros(n_padded, jnp.float32),
        # no pending bucket appends before day 0 (unique sentinels)
        app_pos=(n_padded * cfg.max_infectees
                 + jnp.arange(cfg.infection_buffer, dtype=jnp.int32)),
        app_val=jnp.full(cfg.infection_buffer, n_padded, jnp.int32),
        app_n=jnp.int32(0),
    )

    return CompiledRun(
        cfg=cfg,
        arrays=arrays,
        schedules=jax.tree.map(jnp.asarray, sched_np),
        init_state=jax.tree.map(jnp.asarray, state_np),
        init_carry=init_carry,
        days=days,
        start_date=variables["start_date"],
        random_seed=seed,
        variant_names=variant_names,
        group_labels=pop.group_labels,
        n_agents=int(np.asarray(age_counts).sum()),
        meta={"area_name": variables["area_name"],
              # intermediates for reseed_run (host-side; lets the
              # serving build cache reuse everything seed-independent)
              "_reseed": (pop, disease, ipc, beds, icu)},
    )


def reseed_run(run: CompiledRun, seed: int) -> CompiledRun:
    """A CompiledRun identical to ``run`` except re-seeded: only the
    initial agent state and the capacity scalars depend on
    ``random_seed`` (initial-condition agent picks + severity/duration
    draws, seed_initial_state); arrays/schedules/cfg are shared. Used
    by the serving build cache — rebuilding everything for a new seed
    cost ~8 s at HUS scale while the numpy re-seed is ~0.2 s."""
    from dataclasses import replace

    pop, disease, ipc, beds, icu = run.meta["_reseed"]
    state_np = blank_state(pop)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
    state_np, avail_beds, avail_icu = seed_initial_state(
        state_np, disease, ipc, beds, icu, rng)
    carry = run.init_carry._replace(
        beds_avail=jnp.int32(avail_beds), icu_avail=jnp.int32(avail_icu))
    return replace(run, init_state=jax.tree.map(jnp.asarray, state_np),
                   init_carry=carry, random_seed=seed)


def create_pairs(lst):
    return [(int(a), float(w)) for a, w in lst]


from ..utils.compile import engine_jit


@engine_jit(static_argnums=(0, 6))
def run_chunk(cfg: EngineConfig, arrays: ModelArrays, schedules: Schedules,
              state: AgentState, carry: DayCarry, base_key, chunk_len: int,
              day0):
    """Scan ``chunk_len`` days starting at ``day0``.

    The per-day RNG key material is pre-derived for the whole chunk in
    a handful of batched threefry ops (step.derive_day_keys)."""
    sched_slice = jax.tree.map(
        lambda x: jax.lax.dynamic_slice_in_dim(x, day0, chunk_len), schedules)
    from .step import derive_day_keys
    dkeys = jax.vmap(lambda d: derive_day_keys(cfg, base_key, d))(
        day0 + jnp.arange(chunk_len))

    def body(sc, xs):
        row, dk = xs
        st, cr = sc
        st, cr, out = day_step(cfg, arrays, SchedRow(*row), st, cr,
                               base_key, day_keys=dk)
        return (st, cr), out

    # unroll=2 halves the day-loop's per-iteration overhead at the cost
    # of a larger program to compile (the trajectory is bit-identical)
    (state, carry), outs = jax.lax.scan(
        body, (state, carry), (sched_slice, dkeys), unroll=2)
    return state, carry, outs


@engine_jit()
def _pack_leaves(int_leaves, float_leaves):
    """Concatenate pytree leaves into one i32 + one f32 flat buffer on
    device, so a chunk's outputs reach the host in two transfers
    instead of one per leaf. Exact: every integer output is < 2^24 and
    i32/f32 carry int16/int8/bool losslessly."""
    i = (jnp.concatenate([l.reshape(-1).astype(jnp.int32)
                          for l in int_leaves])
         if int_leaves else jnp.zeros(0, jnp.int32))
    f = (jnp.concatenate([l.reshape(-1).astype(jnp.float32)
                          for l in float_leaves])
         if float_leaves else jnp.zeros(0, jnp.float32))
    return i, f


def _fetch_chunk_packed(outs, problem):
    """Fetch a chunk's DayOutputs (+ the problem scalar) in two host
    transfers; returns (numpy pytree, problem int)."""
    leaves, treedef = jax.tree_util.tree_flatten(outs)
    is_int = [bool(np.issubdtype(np.dtype(l.dtype), np.integer))
              or np.dtype(l.dtype) == np.bool_ for l in leaves]
    ints = [l for l, b in zip(leaves, is_int) if b]
    flts = [l for l, b in zip(leaves, is_int) if not b]
    pi, pf = _pack_leaves(ints + [jnp.reshape(problem, (1,))], flts)
    pi, pf = np.asarray(pi), np.asarray(pf)
    out_leaves = [None] * len(leaves)
    oi = of = 0
    for k, (l, b) in enumerate(zip(leaves, is_int)):
        n = int(np.prod(l.shape, dtype=np.int64))
        if b:
            out_leaves[k] = pi[oi:oi + n].reshape(l.shape).astype(l.dtype)
            oi += n
        else:
            out_leaves[k] = pf[of:of + n].reshape(l.shape).astype(l.dtype)
            of += n
    return jax.tree_util.tree_unflatten(treedef, out_leaves), int(pi[oi])


def check_problems(carry) -> None:
    """Raise SimulationFailed for any set problem bit; accepts a
    DayCarry or a bare problem bitmask."""
    problem = int(carry if isinstance(carry, (int, np.integer))
                  else carry.problem)
    if problem:
        msgs = [s for bit, s in C.PROBLEM_TO_STR.items() if problem & bit]
        raise C.SimulationFailed(", ".join(msgs))


def run_days(run: CompiledRun, n_days: Optional[int] = None,
             chunk_days: int = 32, day_callback=None,
             seed: Optional[int] = None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 64,
             resume: bool = True, mesh=None):
    """Execute the run; returns stacked DayOutputs (numpy pytree) with a
    leading day axis of length ``n_days`` (row 0 = initial snapshot —
    mirroring the reference's emit-then-iterate loop,
    calc/simulation.py:194-270).

    ``day_callback(day_idx, outputs_so_far)`` fires after each chunk;
    returning False cancels the run. With ``checkpoint_dir`` set, full
    simulation state snapshots every ``checkpoint_every`` days and a
    fresh call resumes from the newest snapshot (bit-identical to an
    uninterrupted run — the RNG is counter-based over (seed, day)).

    With ``mesh`` set (a Mesh with an 'agent' axis), the population is
    sharded across the mesh's agent dimension and XLA inserts the
    cross-shard collectives (dart reductions, capacity ledgers,
    new-infection exchange) from the input shardings.
    """
    n_days = n_days if n_days is not None else run.days
    base_key = jr.PRNGKey(run.random_seed if seed is None else seed)
    arrays, schedules = run.arrays, run.schedules
    state, carry = run.init_state, run.init_carry
    cfg = run.cfg
    if mesh is not None:
        from ..parallel.mesh import shard_run
        arrays, schedules, state, carry = shard_run(run, mesh)
    from . import checkpoint as ckpt

    # Chunk outputs accumulate ON DEVICE and fetch in one packed
    # two-transfer fetch at sync points. When nobody is watching
    # mid-run (no callback, no checkpointing) the only sync point is
    # the end of the run.
    sync_each_chunk = (day_callback is not None
                       or checkpoint_dir is not None)

    # day-0 row precedes intervention application (the reference emits
    # generate_state BEFORE iterate applies start_date-dated events,
    # calc/simulation.py:194-270), so mobility is the pristine 1.0 here
    snap = snapshot_outputs(cfg, arrays, state, carry,
                            jnp.float32(1.0))
    pending = [jax.tree.map(lambda x: x[None], snap)]  # device-resident
    rows = []                                          # fetched numpy
    day = 0

    if checkpoint_dir and resume:
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest:
            state, carry, saved_out = ckpt.load_checkpoint(latest)
            if mesh is not None:
                # re-apply the agent-axis placement to the host arrays
                from ..parallel.mesh import place_state_carry
                state, carry = place_state_carry(mesh, state, carry)
            else:
                state = jax.tree.map(jnp.asarray, state)
                carry = jax.tree.map(jnp.asarray, carry)
            day = int(carry.day)
            if saved_out is not None:
                pending = []
                rows = [saved_out]

    def sync_pending():
        """Fetch every device-pending chunk in one packed transfer and
        return the problem bitmask (fail-fast happens at sync points —
        the reference fails at the day boundary, main.pyx:2017-2018;
        deferring the check never changes outputs, only how long a
        poisoned run keeps the device busy)."""
        nonlocal pending
        if pending:
            stacked_dev = (pending[0] if len(pending) == 1
                           else jax.tree.map(
                               lambda *xs: jnp.concatenate(xs, 0), *pending))
            outs_np, problem_val = _fetch_chunk_packed(
                stacked_dev, carry.problem)
            rows.append(outs_np)
            pending = []
            return problem_val
        return int(np.asarray(carry.problem))

    steps_left = (n_days - 1) - day
    import time
    chunk_times = []
    since_ckpt = 0
    while steps_left > 0:
        this_chunk = min(chunk_days, steps_left)
        if this_chunk < chunk_days:
            # remainder steps run as chunk_len=1 dispatches: every
            # DISTINCT chunk_len compiles its own program, and a
            # remainder-sized program would compile MID-RUN. The
            # single-day program is the smallest possible compile and
            # is shared by every remainder of every run shape.
            this_chunk = 1
        t0 = time.perf_counter()
        state, carry, outs = run_chunk(
            cfg, arrays, schedules, state, carry, base_key,
            this_chunk, day)
        pending.append(outs)
        day += this_chunk
        steps_left -= this_chunk
        since_ckpt += this_chunk
        if sync_each_chunk or steps_left == 0:
            check_problems(sync_pending())
        chunk_times.append((this_chunk, time.perf_counter() - t0))
        if checkpoint_dir and (since_ckpt >= checkpoint_every
                               or steps_left == 0):
            stacked = jax.tree.map(lambda *xs: np.concatenate(xs, 0), *rows)
            ckpt.save_checkpoint(ckpt.checkpoint_path(checkpoint_dir, day),
                                 jax.tree.map(np.asarray, state),
                                 jax.tree.map(np.asarray, carry), stacked)
            rows = [stacked]
            since_ckpt = 0
        if day_callback is not None:
            partial_out = jax.tree.map(
                lambda *xs: np.concatenate(xs, axis=0), *rows)
            if not day_callback(day, partial_out):
                raise ExecutionInterrupted()

    check_problems(sync_pending())
    stacked = (rows[0] if len(rows) == 1 else
               jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *rows))
    return stacked, state, carry, chunk_times


class ExecutionInterrupted(Exception):
    """Cooperative cancellation (reference calc/__init__.py:4)."""
