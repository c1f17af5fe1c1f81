"""Monte-Carlo ensembles over seeds.

Replaces the reference's 8-process ``multiprocessing.Pool.map`` over
1000 seeds (calc/simulation.py:349-385).

Execution strategy: by default seeds run SEQUENTIALLY through the one
compiled single-run program. The ``vmap``-batched program runs a batch
of seeds as one program; with a mesh, its 'seed' axis shards the batch
across devices and each device executes its own slice. Scaling across
hosts is process-per-host (init_distributed, parallel/mesh.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from .core.engine import CompiledRun, build_run, check_problems
from .core.step import SchedRow, day_step


from .utils.compile import engine_jit


@engine_jit(static_argnums=(0,), no_persistent_cache=True)
def _ensemble_scan(cfg, arrays, schedules, state, carry, keys):
    """Scan all days for a batch of seeds: vmap(day_step) under lax.scan."""
    def body(sc, row):
        st_b, cr_b = sc
        st_b, cr_b, out = jax.vmap(
            lambda st, cr, k: day_step(cfg, arrays, SchedRow(*row), st, cr, k)
        )(st_b, cr_b, keys)
        return (st_b, cr_b), out

    st_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (keys.shape[0],) + x.shape),
                        state)
    cr_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (keys.shape[0],) + x.shape),
                        carry)
    (st_b, cr_b), outs = jax.lax.scan(body, (st_b, cr_b), schedules)
    # outs: (days, batch, ...) → (batch, days, ...)
    outs = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)
    return st_b, cr_b, outs


def run_ensemble(run: CompiledRun, seeds: List[int],
                 batch_size: int = 1, mesh=None,
                 n_days: Optional[int] = None):
    """Run ``seeds``; returns DayOutputs stacked with a leading
    (n_seeds, days-1) shape (day-0 snapshot omitted — it is identical
    across seeds).

    ``batch_size=1`` (the default) executes seeds sequentially through
    the compiled single-run program. Larger batches vmap seeds into one
    program; with a mesh, its 'seed' axis shards the batch across
    devices."""
    results = []
    placement = None
    if mesh is not None:
        from .parallel.mesh import batch_placement
        placement = batch_placement(mesh, run.init_state.age.shape[0])

    steps = (n_days if n_days is not None else run.days) - 1
    schedules = jax.tree.map(lambda x: x[:steps], run.schedules)

    for i in range(0, len(seeds), batch_size):
        chunk = seeds[i:i + batch_size]
        if len(chunk) == 1 and mesh is None:
            # sequential fast path: reuse the single-run program
            # (mesh runs keep the vmapped path so placement stays
            # uniform across chunks)
            from .core.engine import run_days
            out1, _st, _cr, _t = run_days(run, n_days=steps + 1,
                                          seed=chunk[0])
            results.append(jax.tree.map(
                lambda x: np.asarray(x)[None, 1:], out1))
            continue
        # pad a ragged final chunk by repeating the last seed: a smaller
        # batch axis would force a second full compile of the vmapped
        # engine program (on CPU it burns one of the few big compiles
        # before the known jaxlib segfault)
        n_real = len(chunk)
        chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
        keys = jnp.stack([jr.PRNGKey(s) for s in chunk])
        if placement is not None:
            keys = jax.device_put(keys, placement(keys))
        st_b, cr_b, outs = _ensemble_scan(
            run.cfg, run.arrays, schedules, run.init_state, run.init_carry,
            keys)
        for problem in np.asarray(cr_b.problem)[:n_real]:
            check_problems(int(problem))
        results.append(jax.tree.map(
            lambda x: np.asarray(x)[:n_real], outs))
    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *results)


def run_monte_carlo(scenario_name: str = "default", n_runs: int = 1000,
                    batch_size: int = 1, mesh=None,
                    variables: Optional[Dict] = None,
                    csv_path: Optional[str] = None):
    """Seed sweep for a scenario; returns the concatenated daily frame
    (reference run_monte_carlo, calc/simulation.py:362-385)."""
    import pandas as pd
    from .config import session_store
    from .config.scenarios import get_scenario
    from .config.variables import VariableStore

    store = VariableStore()
    with session_store(store):
        get_scenario(scenario_name).apply()
        variables = store.copy_all()
    variables["random_seed"] = 0

    run = build_run(variables)
    outs = run_ensemble(run, list(range(n_runs)), batch_size, mesh=mesh)

    from .core.step import snapshot_outputs
    from .simulation import outputs_to_frames
    snap = jax.tree.map(
        lambda x: np.asarray(x)[None],
        snapshot_outputs(run.cfg, run.arrays, run.init_state, run.init_carry,
                         run.schedules.mobility_scalar[0]))
    frames = []
    n_days = run.days
    for s in range(n_runs):
        rows = jax.tree.map(lambda x: x[s], outs)
        padded = jax.tree.map(
            lambda a, b: np.concatenate([a, b], axis=0), snap, rows)
        df, _ = outputs_to_frames(padded, run, n_days)
        df["run"] = s
        frames.append(df)
    df = pd.concat(frames)
    df.index.name = "date"
    df = df.reset_index()
    df["scenario"] = scenario_name
    if csv_path:
        df.to_csv(csv_path, index=False)
    return df
