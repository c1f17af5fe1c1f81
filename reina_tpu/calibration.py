"""Parameter-grid calibration sweeps on a device mesh.

The reference has no built-in calibration — its only sweep axis is the
Monte-Carlo seed pool (calc/simulation.py:349-385); fitting model
parameters (e.g. ``infectiousness_multiplier``) against observed case
data (data/hosp_cases_hus.csv) was a manual exercise. Here a grid of
parameter points runs as ONE vmapped XLA program — the model arrays
gain a leading grid axis — and shards over the mesh's 'seed' dimension,
so N devices evaluate N× the grid points of one device at the same
wall-clock.

Scoring follows the reference's empirical-validation framing
(components/results.py:56-94): compare the simulated cumulative
detected-case curve against the observed series for the area.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from .core.engine import CompiledRun, build_run, check_problems
from .core.params import DISEASE_PARAMS
from .core.step import ModelArrays, SchedRow, day_step
from .data import loaders
from .utils.compile import engine_jit

# Grid variables must only affect the compiled disease/model arrays:
# the sweep shares one initial state, schedule set and engine config
# across points, so anything else would be silently ignored.
SWEEPABLE = set(DISEASE_PARAMS)


@engine_jit(static_argnums=(0, 1))
def _grid_scan(cfg, array_axes, arrays_b, schedules, st_b, cr_b, key):
    """Scan all days for a batch of model-array grid points.
    ``array_axes`` marks which ModelArrays fields carry a leading grid
    axis (0) vs are shared across points (None) — shared N-sized
    population arrays are not replicated in HBM. ``st_b``/``cr_b``
    arrive pre-batched: the initial state is seeded through each
    point's OWN disease arrays (severity + duration draws of the
    seeded agents, core/state.py seed_initial_state), so points may
    start from different seeded conditions."""
    axes_tree = ModelArrays(*array_axes)

    def body(sc, row):
        st_b, cr_b = sc
        st_b, cr_b, out = jax.vmap(
            lambda ar, st, cr: day_step(cfg, ar, SchedRow(*row), st, cr, key),
            in_axes=(axes_tree, 0, 0),
        )(arrays_b, st_b, cr_b)
        return (st_b, cr_b), out

    (st_b, cr_b), outs = jax.lax.scan(body, (st_b, cr_b), schedules)
    return cr_b, jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)


def grid_points(grid: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of a {variable: [values]} grid."""
    unknown = set(grid) - SWEEPABLE
    if unknown:
        raise ValueError(
            "grid variables must be disease parameters (they alone feed "
            "the per-point model arrays); not sweepable: %s"
            % ", ".join(sorted(unknown)))
    names = list(grid)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(grid[n] for n in names))]


def _batch_arrays(chunk: List[CompiledRun]):
    """Stack only the ModelArrays fields that actually differ between
    the points; identical (mostly N-sized population) fields stay
    unbatched and are broadcast by vmap."""
    stacked, axes = [], []
    for vals in zip(*(r.arrays for r in chunk)):
        first = np.asarray(vals[0])
        same = all(np.array_equal(first, np.asarray(v)) for v in vals[1:])
        if same:
            stacked.append(vals[0])
            axes.append(None)
        else:
            stacked.append(jnp.stack(vals))
            axes.append(0)
    if 0 not in axes:            # degenerate single-point grids
        axes[-1] = 0
        stacked[-1] = jnp.stack([stacked[-1]] * len(chunk))
    return ModelArrays(*stacked), tuple(axes)


def sweep_grid(variables: Dict[str, Any], grid: Dict[str, Sequence[Any]],
               n_days: Optional[int] = None, batch_size: int = 8,
               mesh=None, pad_multiple: int = 1024,
               age_counts_override=None):
    """Run every grid point; returns (points, DayOutputs, base_run) with
    leading (n_points, days-1) output axes. All points share the
    intervention calendar, population and seed; the compiled disease
    arrays AND the seeded initial state differ per point (initial
    severities/durations are drawn through each point's disease
    arrays). Per-point setup is O(N) host work (build_run); the
    dataset loads are calcfunc-cached across points."""
    points = grid_points(grid)
    runs: List[CompiledRun] = []
    for pt in points:
        v = dict(variables)
        v.update(pt)
        runs.append(build_run(v, pad_multiple=pad_multiple,
                              age_counts_override=age_counts_override))
    base = runs[0]
    steps = (n_days if n_days is not None else base.days) - 1
    schedules = jax.tree.map(lambda x: x[:steps], base.schedules)
    key = jr.PRNGKey(base.random_seed)

    placement = None
    if mesh is not None:
        from .parallel.mesh import batch_placement
        placement = batch_placement(mesh, base.init_state.age.shape[0])

    results = []
    for i in range(0, len(runs), batch_size):
        chunk = runs[i:i + batch_size]
        arrays_b, axes = _batch_arrays(chunk)
        # per-point initial conditions: seeding draws severities and
        # durations through each point's own disease arrays, so swept
        # severity/duration parameters change the seeded state too
        st_b = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *(r.init_state for r in chunk))
        cr_b = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *(r.init_carry for r in chunk))
        if placement is not None:
            arrays_b = jax.tree.map(
                lambda x: jax.device_put(x, placement(x)), arrays_b)
            st_b = jax.tree.map(
                lambda x: jax.device_put(x, placement(x)), st_b)
            cr_b = jax.tree.map(
                lambda x: jax.device_put(x, placement(x)), cr_b)
        carry_b, outs = _grid_scan(base.cfg, axes, arrays_b, schedules,
                                   st_b, cr_b, key)
        for problem in np.asarray(carry_b.problem):
            check_problems(int(problem))
        results.append(jax.tree.map(np.asarray, outs))
    outs = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *results)
    return points, outs, base


def score_against_observed(outs, run: CompiledRun,
                           observed_rows: Optional[List[dict]] = None,
                           metric: str = "all_detected") -> np.ndarray:
    """Least-squares distance in log1p space between each point's
    simulated cumulative series and the observed series, aligned by
    date. Lower is better."""
    from datetime import date, timedelta

    from .core.step import GROUP_ROW

    if observed_rows is None:
        observed_rows = loaders.get_detected_cases(run.meta["area_name"])
    # observed casefile column per simulated metric
    obs_col = {"all_detected": "confirmed", "dead": "dead",
               "in_icu": "in_icu", "in_ward": "in_ward"}
    if metric not in obs_col:
        raise ValueError(f"unsupported calibration metric {metric!r}; "
                         f"choose from {sorted(obs_col)}")
    attr_idx = GROUP_ROW[metric]
    start = date.fromisoformat(run.start_date)
    sim = outs.by_group[..., attr_idx, :].sum(axis=-1)   # (G, days)
    n_days = sim.shape[1]
    obs_by_day = {}
    for r in observed_rows:
        # sweep outputs have no leading snapshot row: sim[j] is the
        # state after day j, i.e. dated start + j + 1 — an observation
        # dated start + d therefore aligns with sim[d - 1]
        d = (date.fromisoformat(r["date"]) - start).days
        if 0 <= d - 1 < n_days:
            obs_by_day[d - 1] = float(r[obs_col[metric]])
    if not obs_by_day:
        raise ValueError("no observed days overlap the simulation window")
    idx = np.array(sorted(obs_by_day))
    obs = np.array([obs_by_day[i] for i in idx])
    diff = np.log1p(sim[:, idx]) - np.log1p(obs)[None, :]
    return (diff ** 2).mean(axis=1)


def calibrate(variables: Dict[str, Any], grid: Dict[str, Sequence[Any]],
              n_days: Optional[int] = None, metric: str = "all_detected",
              observed_rows: Optional[List[dict]] = None,
              batch_size: int = 8, mesh=None, pad_multiple: int = 1024,
              age_counts_override=None) -> Tuple[Dict[str, Any], list]:
    """Evaluate the grid and rank points by fit against observed data.
    Returns (best_point, [(point, score), ...] sorted best-first)."""
    points, outs, base = sweep_grid(
        variables, grid, n_days=n_days, batch_size=batch_size, mesh=mesh,
        pad_multiple=pad_multiple, age_counts_override=age_counts_override)
    scores = score_against_observed(outs, base, observed_rows, metric)
    ranked = sorted(zip(points, scores.tolist()), key=lambda x: x[1])
    return ranked[0][0], ranked
