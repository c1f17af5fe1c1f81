"""Final all_infected of the HUS default 364-day run over several seeds,
against the 1000-seed reference band (docs/parity.md, Validation).

Runs seeds FIRST..FIRST+K-1 one after another through build_run ->
run_days (52-day chunks, the program chip_smoke.py and bench.py compile) and
prints each seed's final all_infected, their mean and standard
deviation, and how far the mean lies from the reference mean in units
of its standard error. Each line names the device; on a GPU also the
card and its power limit.

Usage: python tools/seed_band.py [K [FIRST]]
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF_MEAN, REF_STD = 373466.083, 22395.92


def main() -> None:
    import jax

    from reina_tpu.config.variables import VARIABLE_DEFAULTS
    from reina_tpu.core.engine import build_run, run_days

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    first = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    dev = jax.devices()[0]
    label = f"{dev.platform} {dev.device_kind}"
    if dev.platform == "gpu":
        label = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.splitlines()[0]
    v = dict(VARIABLE_DEFAULTS)
    v["simulation_days"] = 365
    run = build_run(v)
    finals = []
    for seed in range(first, first + k):
        t0 = time.perf_counter()
        out = run_days(run, chunk_days=52, seed=seed)[0]
        finals.append(int(np.asarray(out.by_group)[-1, 3].sum()))
        print(f"seed {seed}: final all_infected {finals[-1]} "
              f"({time.perf_counter() - t0:.3f} s; {label})", flush=True)
    f = np.asarray(finals, np.float64)
    z = (f.mean() - REF_MEAN) / (REF_STD / np.sqrt(k))
    print(f"seeds {first}-{first + k - 1}: mean {f.mean():.1f}, "
          f"std {f.std(ddof=1):.1f}; "
          f"reference {REF_MEAN:.1f} ± {REF_STD:.1f}; mean is {z:+.2f} "
          f"standard errors from the reference ({label})")


if __name__ == "__main__":
    main()
