#!/usr/bin/env python3
"""Start-up proof of the REINA engine on NVIDIA GPUs.

    python chip_smoke.py          one GPU: op checks at HUS width, a
                                  364-day HUS run through build_run ->
                                  run_days, and the vmapped ensemble
    python chip_smoke.py --four   four GPUs: an agent-sharded HUS run and
                                  a seed-sharded ensemble, each against
                                  the same runs on one GPU

Every phase checks its own results and any failed check exits non-zero.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
Where JAX finds no GPU, or the ``reina_tpu`` package is not beside this
script, it exits non-zero without that line. One process holds the
card(s); ``nvidia-smi`` is its only child.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# 1000-seed reference of the final (day 364) all_infected count of the
# HUS default run (docs/parity.md, Validation)
FINAL_ALL_INFECTED_MEAN = 373466.083
FINAL_ALL_INFECTED_STD = 22395.92
BAND_SIGMAS = 4.0

MAIN_DAYS = 365          # 364 steps = 7 chunks of 52: no remainder program
MAIN_CHUNK = 52
ENSEMBLE_SEEDS = [0, 1, 2, 3]
ENSEMBLE_DAYS = 9
FOUR_DAYS = 30           # 29 steps, one chunk
TIMING_CALLS = 20


class CheckFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


# ---------------------------------------------------------------- device

def device_phase(need: int):
    """Require ``need`` GPUs; print what JAX and nvidia-smi report.
    Returns (devices, card label for stamping numbers)."""
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise CheckFailed(f"needs a GPU, but JAX found platform "
                          f"{d0.platform!r} ({d0.device_kind})")
    require(len(devs) >= need,
            f"needs {need} GPUs, JAX found {len(devs)}")
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    cards = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    for c in cards:
        log(f"card: {c}")
    has_pandas = importlib.util.find_spec("pandas") is not None
    log(f"pandas importable: {has_pandas}")
    return devs, cards[0]


def build_hus_run(days: int):
    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu.core.engine import build_run

    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = days
    t0 = time.perf_counter()
    run = build_run(v)
    log(f"build_run HUS: {time.perf_counter() - t0:.3f} s, agents="
        f"{run.n_agents}, padded={run.init_state.age.shape[0]}")
    return run


# ------------------------------------------------------------ op checks

def median_ms(fn, *args, calls: int = TIMING_CALLS) -> float:
    """Median wall time of ``calls`` calls, each ended by
    block_until_ready (compiled and warmed first)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def sequential_grants(releases, requests, init, offset):
    """The reference's literal cyclic sweep (main.pyx:617-648)."""
    rel = releases.tolist()
    req = requests.tolist()
    n = len(rel)
    bal = int(init)
    granted = [False] * n
    for i in range(n):
        p = (offset + i) % n
        bal += rel[p]
        if req[p] and bal > 0:
            bal -= 1
            granted[p] = True
    return granted, bal


def op_inputs(run, seed: int = 7):
    """Host inputs for the op checks: the run's own code arrays (ages,
    output groups) plus seeded random masks, weights and offsets at the
    run's full agent width."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = run.arrays
    N = int(a.ages.shape[0])
    A = int(a.age_start.shape[0]) - 1
    V = run.cfg.nr_variants
    from reina_tpu.core import constants as C
    VTS = V * C.IOT_LEN * 2
    exposer = rng.random(N) < 0.02
    return dict(
        N=N, A=A, V=V, VTS=VTS, G=run.cfg.nr_groups,
        ages=np.asarray(a.ages), groups=np.asarray(a.group_of_agent),
        rel=(rng.random((2, N)) < 0.2).astype(np.int32),
        req=rng.random((2, N)) < 0.3,
        init=np.array([50, 5], np.int32),
        offset=int(rng.integers(0, N)),
        masks=rng.random((10, N)) < 0.3,
        eligible=rng.random(N) < 0.5,
        code_a=np.where(exposer, rng.integers(0, VTS, N), -1).astype(
            np.int32),
        k_s=rng.integers(0, 129, N).astype(np.float32),
        newly=rng.random(N) < 0.01,
        c_s=np.where(exposer, rng.random(N) * 50, 0).astype(np.float32),
        variant=rng.integers(0, V, N).astype(np.int32),
    )


def check_ops(run, label: str = "", time_ops: bool = True):
    """Each plain op of the day step at the run's width against a numpy
    reference; prints deviation, tolerance and precision, then (with
    ``time_ops``) the median time of each. Raises CheckFailed."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from reina_tpu.core.step import dart_success
    from reina_tpu.ops.clamped import clamped_counter_grants
    from reina_tpu.ops.compact import concat_cumsum
    from reina_tpu.ops.histogram import bihistogram, onehot_counts

    x = op_inputs(run)
    N, A, V, VTS, G = x["N"], x["A"], x["V"], x["VTS"], x["G"]
    dev = {k: jnp.asarray(v) for k, v in x.items()
           if isinstance(v, np.ndarray)}
    failures = []
    timed = {}

    def report(name, dev_value, tol, precision):
        ok = dev_value <= tol
        log(f"check {name}: max deviation {dev_value:.3e} "
            f"(tolerance {tol:.1e}, {precision}) {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    # ledgers: both columns in one call, against the sequential sweep
    ledger = jax.jit(lambda r0, r1, q0, q1, init, off:
                     clamped_counter_grants([r0, r1], [q0, q1], init, off))
    largs = (dev["rel"][0], dev["rel"][1], dev["req"][0], dev["req"][1],
             dev["init"], jnp.int32(x["offset"]))
    (g0, g1), fin = ledger(*largs)
    bad = 0
    for led, g in enumerate((g0, g1)):
        want_g, want_b = sequential_grants(x["rel"][led], x["req"][led],
                                           x["init"][led], x["offset"])
        bad += int(np.sum(np.asarray(g) != np.asarray(want_g)))
        bad += abs(int(np.asarray(fin)[led]) - want_b)
    report("ledger_grants (2 ledgers, mismatched grants + final)", bad,
           0, "int32, exact")
    timed["ledger_grants"] = (ledger, largs)

    # histograms: output groups, vaccination ages, dart groups
    groups = jax.jit(lambda m, c: onehot_counts(list(m), c, G + 1))
    got = np.asarray(groups(dev["masks"], dev["groups"]))
    want = np.stack([np.bincount(x["groups"][m], minlength=G + 1)
                     for m in x["masks"]])
    report("group_counts (10 masks x output groups)",
           float(np.abs(got - want).max()), 0, "bf16 0/1, f32 sums")
    timed["group_counts"] = (groups, (dev["masks"], dev["groups"]))

    by_age = jax.jit(lambda e, c: onehot_counts([e], c, A))
    got = np.asarray(by_age(dev["eligible"], dev["ages"]))[0]
    want = np.bincount(x["ages"][x["eligible"]], minlength=A)[:A]
    report("vaccination_counts (ages)", float(np.abs(got - want).max()),
           0, "bf16 0/1, f32 sums")
    timed["vaccination_counts"] = (by_age, (dev["eligible"], dev["ages"]))

    bihist = jax.jit(lambda ca, w, cb: bihistogram(ca, VTS, w, cb, A))
    got = np.asarray(bihist(dev["code_a"], dev["k_s"], dev["ages"]))
    want = np.zeros((VTS, A))
    ok = x["code_a"] >= 0
    np.add.at(want, (x["code_a"][ok], x["ages"][ok]), x["k_s"][ok])
    report("bihistogram (dart groups x ages)",
           float(np.abs(got - want).max()), 0, "f32 sums of integers")
    timed["bihistogram"] = (bihist, (dev["code_a"], dev["k_s"],
                                     dev["ages"]))

    # prefix sums
    cnt = jax.jit(lambda m: jnp.cumsum(m.astype(jnp.float32)))
    got = np.asarray(cnt(dev["newly"]))
    report("cum_newly (count prefix)",
           float(np.abs(got - np.cumsum(x["newly"])).max()), 0,
           "f32 integers, exact")
    timed["cum_newly"] = (cnt, (dev["newly"],))

    cat = jax.jit(lambda w, c: concat_cumsum(w, c, V))
    got = np.asarray(cat(dev["c_s"], dev["variant"])).astype(np.float64)
    want = np.cumsum(np.concatenate(
        [np.where(x["variant"] == v, x["c_s"].astype(np.float64), 0.0)
         for v in range(V)]))
    report("cum_cat (max |err| / total)",
           float(np.abs(got - want).max() / want[-1]), 1e-6,
           "f32 cumsum vs float64")
    timed["cum_cat"] = (cat, (dev["c_s"], dev["variant"]))

    # the dart-success contraction on the model's contact tensor, with
    # the last schedule day's mobility and masks
    a = run.arrays
    mob = run.schedules.mobility[-1]
    q = a.contact_base * mob[:, :, None]
    q_hat = q / jnp.maximum(jnp.sum(q, axis=(1, 2)), 1e-9)[:, None, None]
    m = run.schedules.mask_p[-1]
    a_ = m[None] * a.mask_po[:, None, None]
    b_ = m[None] * a.mask_pw[:, None, None]
    save = a_ + b_ - a_ * b_
    tq = jax.jit(dart_success)
    got = np.asarray(tq(q_hat, save, a.sigma_max)).astype(np.float64)
    want = np.einsum("apb,vap->vab", np.asarray(q_hat, np.float64),
                     1.0 - np.asarray(save, np.float64)) \
        * np.asarray(a.sigma_max, np.float64)[:, None, :]
    scale = np.abs(want).max()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30 * scale)
    report("Tq einsum (max relative error)", float(rel.max()), 1e-6,
           "f32 HIGHEST vs float64")
    timed["Tq_einsum"] = (tq, (q_hat, save, a.sigma_max))

    if failures:
        raise CheckFailed(f"op checks failed: {failures}")
    if not time_ops:
        return

    iN = jnp.asarray(np.arange(N, dtype=np.int32) % 7 - 3)
    timed["floor (x + 1, int32 N)"] = (jax.jit(lambda v: v + 1), (iN,))
    timed["lone cumsum int32 N"] = (jax.jit(jnp.cumsum), (iN,))
    timed["lone cummax int32 N"] = (jax.jit(lax.cummax), (iN,))
    timed.update(elementwise_sites(run))
    for name, (fn, args) in timed.items():
        log(f"time {name}: {median_ms(fn, *args):.4f} ms "
            f"(median of {TIMING_CALLS}, N={N}; {label})")


def elementwise_sites(run, seed: int = 11):
    """The day step's four elementwise passes, jitted alone on the run's
    day-0 agent fields plus seeded masks of the right dtypes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from reina_tpu.core import step as S

    rng = np.random.default_rng(seed)
    a, s = run.arrays, run.init_state
    N = int(s.age.shape[0])
    V = run.cfg.nr_variants
    B = int(a.band_counts.shape[0])

    def mask(p=0.01):
        return jnp.asarray(rng.random(N) < p)

    def unif():
        return jnp.asarray(rng.random(N).astype(np.float32))

    day = jnp.int32(200)
    prologue = (s.state, s.days_left, s.day_of_illness, s.day_of_infection,
                s.severity, s.variant, s.was_detected, s.is_infected,
                s.active, jnp.asarray(rng.standard_normal(N), jnp.float32),
                jnp.full(N, 10.0, jnp.float32), s.included_in_totals,
                s.n_infected, a.iot, a.asymp_mult, a.inf_mult, day)
    recv = ((a.band_ag,) + tuple(a.lam_log1p_ag[v] for v in range(V))
            + (s.is_infected, s.has_immunity, s.active, unif(), unif(),
               s.state, s.day_of_infection, s.days_left, s.o2r, s.severity,
               s.was_detected, s.death_outside, s.day_of_illness, unif(),
               s.variant, jnp.full((V, B), 1000.0, jnp.float32),
               a.ratio_before_hosp, a.ratio_in_ward,
               jnp.stack([day, jnp.int32(1)]), jnp.float32(0.1)))
    post = ((s.state, s.severity, s.variant, s.o2r, s.days_left)
            + tuple(mask() for _ in range(2)) + (unif(),)
            + tuple(mask() for _ in range(7))
            + (s.was_detected, s.is_infected, s.has_immunity, s.ever_icu,
               mask(), a.ratio_before_hosp, a.ratio_in_ward,
               a.p_icu_death_no_beds, a.p_hosp_death_no_beds))
    i32 = jnp.int32
    fin = (s.state.astype(i32), s.severity.astype(i32),
           s.variant.astype(i32), s.variant.astype(i32), s.days_left,
           s.day_of_illness, s.day_of_infection, mask(), s.is_infected,
           s.traceable, mask(), mask(), day, jnp.bool_(True))
    return {
        "phase4_prologue": (jax.jit(S._phase4_prologue), prologue),
        "receiver+phase5_front": (jax.jit(S._make_recv_front_body(V, B)),
                                  recv),
        "phase5_post": (jax.jit(S._phase5_post), post),
        "finalize": (jax.jit(S._finalize_body), fin),
    }


# ------------------------------------------------------ run-level checks

def first_difference(a, b):
    """(day, field) of the first differing entry of two DayOutputs
    pytrees with a leading day axis, or None when identical."""
    import numpy as np

    first = None
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.shape != y.shape:
            return (0, f"{name} (shape {x.shape} vs {y.shape})")
        diff = (x != y).reshape(x.shape[0], -1).any(axis=1)
        if diff.any():
            d = int(np.argmax(diff))
            if first is None or d < first[0]:
                first = (d, name)
    return first


def check_outputs(out, n_agents: int, what: str) -> None:
    """Population conservation on every day of stacked DayOutputs
    (leading day axis), and non-negative capacity ledgers."""
    import numpy as np

    bg = np.asarray(out.by_group).astype(np.int64)
    susceptible = bg[:, 0].sum(axis=1)
    infected = bg[:, 2].sum(axis=1)
    all_infected = bg[:, 3].sum(axis=1)
    dead = bg[:, 9].sum(axis=1)
    recovered = bg[:, 10].sum(axis=1)
    require((susceptible + all_infected == n_agents).all(),
            f"{what}: susceptible + all_infected != {n_agents} on day(s) "
            f"{np.nonzero(susceptible + all_infected != n_agents)[0][:5]}")
    require((dead + recovered + infected == all_infected).all(),
            f"{what}: dead + recovered + infected != all_infected")
    require((np.asarray(out.available_hospital_beds) >= 0).all()
            and (np.asarray(out.available_icu_units) >= 0).all(),
            f"{what}: a capacity ledger went negative")
    log(f"{what}: agent count conserved on all {bg.shape[0]} days")


def report_identity(what: str, a, b) -> bool:
    diff = first_difference(a, b)
    if diff is None:
        log(f"{what}: identical")
        return True
    log(f"{what}: DIFFER, first at day {diff[0]} in field {diff[1]}")
    return False


def main_path(run, card: str, dev):
    """build_run -> run_days over 364 days, cold then warmed."""
    import numpy as np

    from reina_tpu.core.engine import run_days

    steps = MAIN_DAYS - 1
    first = {}
    t0 = time.perf_counter()

    def on_chunk(day, _partial):
        first.setdefault("s", time.perf_counter() - t0)
        return True

    out, _st, carry, _t = run_days(run, chunk_days=MAIN_CHUNK,
                                   day_callback=on_chunk)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, _st, carry, _t = run_days(run, chunk_days=MAIN_CHUNK)
    wall = time.perf_counter() - t0
    require(int(np.asarray(carry.problem)) == 0, "problem bits set")
    check_outputs(out, run.n_agents, "364-day HUS run")
    final = int(np.asarray(out.by_group)[-1, 3].sum())
    lo = FINAL_ALL_INFECTED_MEAN - BAND_SIGMAS * FINAL_ALL_INFECTED_STD
    hi = FINAL_ALL_INFECTED_MEAN + BAND_SIGMAS * FINAL_ALL_INFECTED_STD
    log(f"final all_infected (day {steps}): {final}; reference "
        f"{FINAL_ALL_INFECTED_MEAN:.0f} ± {BAND_SIGMAS:.0f}x"
        f"{FINAL_ALL_INFECTED_STD:.0f} = [{lo:.0f}, {hi:.0f}]")
    require(lo <= final <= hi, f"final all_infected {final} outside "
            f"[{lo:.0f}, {hi:.0f}]")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)
    log(f"compile + first chunk: {first['s']:.3f} s ({card})")
    log(f"cold 364-day run_days (compile included): {cold:.3f} s ({card})")
    log(f"warmed 364-day wall: {wall:.4f} s, {wall / steps * 1e3:.4f} "
        f"ms/day, {run.n_agents * steps / wall:.1f} agent-days/s ({card})")
    log(f"peak_bytes_in_use: {peak} ({card})")
    return out


def vmapped_path(run, main_out, card: str):
    """The vmapped ensemble program (what calibration and mesh
    ensembles compile), seed 0 against the single-run path."""
    from reina_tpu.ensemble import run_ensemble

    t0 = time.perf_counter()
    batch = run_ensemble(run, seeds=ENSEMBLE_SEEDS,
                         batch_size=len(ENSEMBLE_SEEDS), n_days=ENSEMBLE_DAYS)
    log(f"vmapped ensemble {len(ENSEMBLE_SEEDS)} seeds x "
        f"{ENSEMBLE_DAYS - 1} days (compile included): "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    import jax
    for i, s in enumerate(ENSEMBLE_SEEDS):
        check_outputs(jax.tree.map(lambda v: v[i], batch), run.n_agents,
                      f"vmapped seed {s}")
    if run.random_seed == ENSEMBLE_SEEDS[0]:
        single = main_out
    else:
        from reina_tpu.core.engine import run_days
        single = run_days(run, seed=ENSEMBLE_SEEDS[0])[0]
    steps = ENSEMBLE_DAYS - 1
    report_identity(f"vmapped seed {ENSEMBLE_SEEDS[0]} vs run_days, "
                    f"days 1-{steps}",
                    jax.tree.map(lambda v: v[0], batch),
                    jax.tree.map(lambda v: v[1:steps + 1], single))


def four_cards(run, card: str):
    """Agent-sharded run_days and a seed-sharded ensemble on a 4-GPU
    mesh, each against the same runs on device 0. The three programs
    (agent-sharded, seed-sharded, device 0) compile concurrently in
    threads: compilation dominates this phase and releases the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from reina_tpu.core.engine import run_days
    from reina_tpu.ensemble import run_ensemble
    from reina_tpu.parallel.mesh import make_mesh

    steps = FOUR_DAYS - 1

    def timed(what, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"{what} (compile included): {time.perf_counter() - t0:.3f} s "
            f"({card})")
        return out

    with ThreadPoolExecutor(3) as pool:
        jobs = [
            pool.submit(timed, f"agent-sharded 1x4 run_days, {steps} days",
                        run_days, run, n_days=FOUR_DAYS, chunk_days=steps,
                        mesh=make_mesh(n_seed=1, n_agent=4)),
            pool.submit(timed, f"device-0 run_days, {steps} days",
                        run_days, run, n_days=FOUR_DAYS, chunk_days=steps),
            pool.submit(timed, f"seed-sharded 4x1 ensemble, "
                        f"{len(ENSEMBLE_SEEDS)} seeds x {steps} days",
                        run_ensemble, run, seeds=ENSEMBLE_SEEDS,
                        batch_size=len(ENSEMBLE_SEEDS), n_days=FOUR_DAYS,
                        mesh=make_mesh(n_seed=4, n_agent=1)),
        ]
        sharded, single, ens = [j.result() for j in jobs]
    sharded, single = sharded[0], single[0]
    check_outputs(sharded, run.n_agents, "agent-sharded run")
    check_outputs(single, run.n_agents, "device-0 run")
    report_identity(f"agent-sharded vs device 0, days 0-{steps}",
                    sharded, single)
    for i, s in enumerate(ENSEMBLE_SEEDS):
        member = jax.tree.map(lambda v: v[i], ens)
        check_outputs(member, run.n_agents, f"seed-sharded seed {s}")
        seq = run_days(run, n_days=FOUR_DAYS, chunk_days=steps, seed=s)[0]
        report_identity(f"seed-sharded seed {s} vs sequential run, "
                        f"days 1-{steps}", member,
                        jax.tree.map(lambda v: v[1:], seq))


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    try:
        if not os.path.isdir(os.path.join(HERE, "reina_tpu")):
            raise CheckFailed("the reina_tpu package is not beside "
                              "chip_smoke.py")
        sys.path.insert(0, HERE)
        devs, card = device_phase(4 if args.four else 1)
        run = build_hus_run(FOUR_DAYS if args.four else MAIN_DAYS)
        if args.four:
            four_cards(run, card)
        else:
            check_ops(run, card)
            main_out = main_path(run, card, devs[0])
            vmapped_path(run, main_out, card)
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
