"""Measure the infectee-bucket trajectory over the headline run.

Prints bucket fill statistics (max fill = how close the run comes to
the reference's MAX_INFECTEES=64 cap), the drained-queue proxy
(ct_cases) and per-day new-infection counts at every 28-day chunk
boundary, to size the tracing tiers from data instead of guesswork.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.random as jr

from reina_tpu.utils.compile import enable_persistent_cache
enable_persistent_cache()
from reina_tpu.config.variables import VARIABLE_DEFAULTS
from reina_tpu.core.engine import build_run, run_chunk


def main():
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = 365
    run = build_run(v)
    key = jr.PRNGKey(run.random_seed)
    state, carry = run.init_state, run.init_carry
    day = 0
    print("day  fill>0  fill_p99/max  ct_p50/max  "
          "daily_inf(min/p50/p90/max in chunk)")
    while day < 364:
        state, carry, outs = run_chunk(run.cfg, run.arrays, run.schedules,
                                       state, carry, key, 28, day)
        day += 28
        fill = np.asarray(carry.bkt_fill)
        nz = fill[fill > 0]
        p99 = int(np.percentile(nz, 99)) if len(nz) else 0
        ct = np.asarray(outs.ct_cases_per_day)
        gi = np.asarray(outs.by_group)  # (28, rows, groups)
        # row 3 = all_infected cumulative; daily new = diff
        tot = gi[:, 3].sum(axis=-1)
        daily = np.diff(np.concatenate([[tot[0]], tot]))
        q = np.percentile(daily, [0, 50, 90, 100]).astype(int)
        print(f"{day:4d} {len(nz):7d}  {p99}/{int(fill.max())}"
              f"  {int(np.percentile(ct, 50))}/{int(ct.max())}"
              f"  {q[0]}/{q[1]}/{q[2]}/{q[3]}", flush=True)


if __name__ == "__main__":
    main()
