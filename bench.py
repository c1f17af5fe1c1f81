"""Headline benchmark: wall clock of a 365-day HUS run (~1.7M agents) on
one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "wall_s": ..., "ms_per_day": ...,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}

Secondary detail goes to stderr. Exits non-zero, naming the platform,
when JAX finds no GPU: a number from another backend is not this
benchmark's number.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

CHUNK = 52          # 364 steps = 7 chunks: one compiled program


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found platform {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.splitlines()[0]

    import jax.random as jr

    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu.core.engine import build_run, run_chunk

    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = 365

    t0 = time.perf_counter()
    run = build_run(v)
    print(f"build: {time.perf_counter() - t0:.1f}s, agents={run.n_agents}, "
          f"padded={run.init_state.age.shape[0]}, card={card}",
          file=sys.stderr)
    key = jr.PRNGKey(run.random_seed)

    # warm-up: compile the chunk program and run the first chunk
    t0 = time.perf_counter()
    _, _, outs = run_chunk(run.cfg, run.arrays, run.schedules,
                           run.init_state, run.init_carry, key, CHUNK, 0)
    np.asarray(outs.by_group)
    print(f"compile+first chunk: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # timed full run from a fresh state with the compiled program; the
    # host transfer at the end waits for the last chunk
    t0 = time.perf_counter()
    state, carry = run.init_state, run.init_carry
    day = 0
    for _ in range(364 // CHUNK):
        state, carry, outs = run_chunk(run.cfg, run.arrays, run.schedules,
                                       state, carry, key, CHUNK, day)
        day += CHUNK
    infected_final = int(np.asarray(outs.by_group)[-1, 3].sum())
    wall = time.perf_counter() - t0
    print(f"wall: {wall:.4f}s for {day} steps ({wall / day * 1000:.4f} "
          f"ms/day), final all_infected={infected_final}", file=sys.stderr)

    print(json.dumps({
        "metric": "hus_365d_agent_days_per_sec",
        "value": run.n_agents * day / wall,
        "unit": "agent-days/s",
        "wall_s": wall,
        "ms_per_day": wall / day * 1000,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
