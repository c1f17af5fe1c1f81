"""Simulation driver (reference: calc/simulation.py).

Produces the same two DataFrames as the reference's
``simulate_individuals``: a daily frame of population/state/exposure
attributes plus ``us_per_infected`` throughput, and a
(date × attr × age-group) cube. Supports streamed partial results via
``step_callback`` with cooperative cancellation.
"""
from __future__ import annotations

from datetime import date
from typing import Callable, Dict, Optional

import numpy as np
import pandas as pd

from .config import variables as var_mod
from .core import constants as C
from .core.engine import CompiledRun, ExecutionInterrupted, build_run, run_days
from .core.params import DISEASE_PARAMS, create_disease_params  # noqa: F401
from .utils.memoize import calcfunc
from .utils.perf import PerfCounter

# Daily output attribute sets (reference calc/simulation.py:17-47)
POP_ATTRS = [
    "susceptible", "vaccinated", "infected", "detected", "all_detected",
    "in_ward", "in_icu", "dead", "non_hospital_deaths", "recovered",
    "all_infected", "new_infections",
]
EXPOSURES_ATTRS = ["exposures_%s" % p for p in C.PLACES]
STATE_ATTRS = [
    "exposed_per_day", "available_hospital_beds", "available_icu_units",
    "total_icu_units", "ct_cases_per_day", "r", "mobility_limitation",
]

# Position of each POP_ATTR row in DayOutputs.by_group — defined once
# next to the masks that produce it (core/step.py)
from .core.step import GROUP_ROW as _GROUP_ROW  # noqa: E402


def _resolve_variables(variable_store: Optional[dict] = None) -> Dict:
    out = {}
    for name in var_mod.VARIABLE_DEFAULTS:
        out[name] = var_mod.get_variable(name, var_store=variable_store)
    return out


# Serving-path build cache: build_run costs seconds of host work at HUS
# scale (population/schedule compilation + device transfers). Repeat runs
# of the same resolved-variable set — the common UI case of re-running
# with a new random seed is a DIFFERENT set, but polling re-entries and
# dedup'd runs are not — reuse the compiled run. The CompiledRun is
# read-only to the engine (purely functional day step), so sharing
# across worker threads is safe.
import json as _json
import threading as _threading

_BUILD_CACHE: Dict[str, CompiledRun] = {}
_BUILD_LOCK = _threading.Lock()
_BUILD_CACHE_MAX = 2


def _cached_build_run(variables: Dict) -> CompiledRun:
    # keyed WITHOUT random_seed: the reference UI bumps the seed per
    # run (corona.py:576-578), and only the initial state depends on
    # it — a cache hit with a new seed re-seeds in ~0.2 s
    # (engine.reseed_run) instead of rebuilding for ~8 s
    seed = variables.get("random_seed")
    key = _json.dumps({k: v for k, v in variables.items()
                       if k != "random_seed"},
                      sort_keys=True, default=str)
    with _BUILD_LOCK:
        run = _BUILD_CACHE.get(key)
    if run is not None:
        from .core.engine import reseed_run
        return run if run.random_seed == seed else reseed_run(run, seed)
    run = build_run(variables)
    with _BUILD_LOCK:
        if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
            _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
        _BUILD_CACHE[key] = run
    return run


def outputs_to_frames(out, run: CompiledRun, n_days: int,
                      us_per_infected: Optional[np.ndarray] = None):
    """DayOutputs pytree → (daily df, age-group cube df)."""
    start = date.fromisoformat(run.start_date)
    idx = pd.date_range(start, periods=n_days)
    rec: Dict[str, np.ndarray] = {}
    for attr in POP_ATTRS:
        rec[attr] = out.by_group[:, _GROUP_ROW[attr]].sum(axis=1)
    rec["exposed_per_day"] = out.exposed_per_day
    rec["available_hospital_beds"] = out.available_hospital_beds
    rec["available_icu_units"] = out.available_icu_units
    rec["total_icu_units"] = out.total_icu_units
    rec["ct_cases_per_day"] = out.ct_cases_per_day
    rec["r"] = out.r
    rec["mobility_limitation"] = out.mobility_limitation
    for p_i, name in enumerate(EXPOSURES_ATTRS):
        rec[name] = out.exposures_by_place[:, p_i]
    rec["us_per_infected"] = (us_per_infected if us_per_infected is not None
                              else np.zeros(n_days))
    # per-variant daily infections: the reference exposes
    # infected_by_variant (keyed by variant name) in every
    # generate_state dict (main.pyx:1847-1850); serialized here as
    # prefix columns so the takeover curve reaches every consumer
    for v_i, name in enumerate(run.variant_names):
        rec["infected_by_variant_%s" % name] = out.infected_by_variant[:, v_i]
    df = pd.DataFrame(rec, index=idx)

    cube = out.by_group[:, [_GROUP_ROW[a] for a in POP_ATTRS], :]
    adf = pd.DataFrame(
        cube.reshape(n_days * len(POP_ATTRS) * len(run.group_labels)),
        index=pd.MultiIndex.from_product(
            [idx, POP_ATTRS, run.group_labels],
            names=["date", "attr", "age_group"]),
        columns=["pop"],
    )
    adf = adf.unstack("attr").unstack("age_group")
    adf.columns = adf.columns.droplevel()
    return df, adf


@calcfunc(
    variables=list(DISEASE_PARAMS) + [
        "simulation_days", "interventions", "active_scenario", "scenarios",
        "start_date", "hospital_beds", "icu_units", "random_seed", "max_age",
        "imported_infection_ages", "area_name",
        "incubating_at_simulation_start", "ill_at_simulation_start",
        "recovered_at_simulation_start",
    ],
)
def simulate_individuals(step_callback: Optional[Callable] = None,
                         callback_day_interval: int = 1,
                         variables: Optional[Dict] = None):
    """Run a full simulation; returns (daily df, age-group cube df).

    Mirrors reference calc/simulation.py:148-290. ``step_callback``
    receives the partial daily DataFrame; returning a falsy value
    cancels the run (→ ExecutionInterrupted)."""
    pc = PerfCounter()
    run = _cached_build_run(variables)
    pc.measure()

    n_days = variables["simulation_days"]
    us_rows = np.zeros(n_days, dtype=np.float64)
    chunk = max(callback_day_interval, 1) if step_callback else 32

    # output row 0 is the initial snapshot (emit-then-iterate): no
    # simulated day produced it, so the perf accounting starts at row 1
    cb_state = {"done": 1}

    def day_cb(day_idx, partial):
        rows = day_idx + 1
        ms = pc.measure()
        # wall-µs per infected agent per day (calc/simulation.py:212),
        # averaged over the chunk just computed
        infected = partial.by_group[:rows, _GROUP_ROW["infected"]].sum(axis=1)
        done = cb_state["done"]
        per_day_ms = ms / max(rows - done, 1)
        for d in range(done, rows):
            us_rows[d] = per_day_ms * 1000 / infected[d] if infected[d] else 0
        cb_state["done"] = rows
        if step_callback is None:
            return True
        df, _ = outputs_to_frames_partial(partial, rows, variables,
                                          us_per_infected=us_rows[:rows])
        return bool(step_callback(df))

    out, state, carry, times = run_days(
        run, n_days=n_days, chunk_days=chunk, day_callback=day_cb)

    df, adf = outputs_to_frames(out, run, n_days, us_rows)
    return df, adf


def outputs_to_frames_partial(partial, rows, variables,
                              us_per_infected=None):
    start = date.fromisoformat(variables["start_date"])
    idx = pd.date_range(start, periods=rows)
    rec = {}
    for attr in POP_ATTRS:
        rec[attr] = partial.by_group[:rows, _GROUP_ROW[attr]].sum(axis=1)
    rec["exposed_per_day"] = partial.exposed_per_day[:rows]
    rec["available_hospital_beds"] = partial.available_hospital_beds[:rows]
    rec["available_icu_units"] = partial.available_icu_units[:rows]
    rec["total_icu_units"] = partial.total_icu_units[:rows]
    rec["ct_cases_per_day"] = partial.ct_cases_per_day[:rows]
    rec["r"] = partial.r[:rows]
    rec["mobility_limitation"] = partial.mobility_limitation[:rows]
    for p_i, name in enumerate(EXPOSURES_ATTRS):
        rec[name] = partial.exposures_by_place[:rows, p_i]
    # the reference streams the REAL per-day throughput in every
    # partial frame (calc/simulation.py:212)
    rec["us_per_infected"] = (us_per_infected if us_per_infected is not None
                              else np.zeros(rows))
    names = ["wild-type"] + [v["name"] for v in variables["variants"]]
    for v_i, name in enumerate(names):
        rec["infected_by_variant_%s" % name] = \
            partial.infected_by_variant[:rows, v_i]
    return pd.DataFrame(rec, index=idx), None


def sample_model_parameters(what: str, age: int, severity: Optional[str] = None,
                            variables: Optional[Dict] = None):
    """Distribution sampling for the parameter-explorer UI
    (reference calc/simulation.py:301-346 + main.pyx:2047-2101)."""
    from .sampling import sample_distribution
    if variables is None:
        variables = _resolve_variables()
    return sample_distribution(what, age, severity, variables)
