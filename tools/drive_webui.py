"""Web-UI drive server: the REAL GraphQL server + web UI with the
engine swapped for a fast fake, so a browser (or scripted client) can
exercise run→poll→chart, zoom/pan/reset and PNG export without an accelerator
or a multi-minute compile.

The fake streams three partial frames on the reference cadence and
finishes with a 60-day epidemic-shaped table, exercising the exact
worker/cache/GraphQL plumbing (runner.SimulationThread, phase keys,
results_to_metrics) that the production path uses.

Usage: PORT=5099 python tools/drive_webui.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pandas as pd


def fake_simulate(step_callback=None, callback_day_interval=1,
                  variable_store=None):
    days = 60
    idx = pd.date_range("2020-02-18", periods=days)
    t = np.arange(days, dtype=float)
    infected = 4000.0 * np.exp(-0.5 * ((t - 35.0) / 10.0) ** 2)
    detected = infected * 0.3
    # column set = the metric registry's non-categorized ids (the
    # GraphQL results_to_metrics post-processor requires every one)
    rec = {
        "susceptible": 1.66e6 - np.cumsum(infected),
        "infected": infected,
        "all_infected": np.cumsum(infected),
        "detected": detected,
        "all_detected": np.cumsum(detected),
        "in_ward": infected * 0.05,
        "in_icu": infected * 0.01,
        "dead": np.cumsum(infected) * 0.005,
        "recovered": np.cumsum(infected) * 0.9,
        "new_infections": infected,
        "available_hospital_beds": 2600 - infected * 0.05,
        "available_icu_units": 300 - infected * 0.01,
        "total_icu_units": np.full(days, 300.0),
        "r": 1.2 - 0.01 * t,
        "ifr_unused": np.zeros(days),  # ifr/cfr derived by the API
        "mobility_limitation": np.clip(t / 100, 0, 0.3),
        "us_per_infected": np.full(days, 4.0),
        "infected_by_variant_wild-type": infected * 0.7,
        "infected_by_variant_b.1.1.7": infected * 0.3,
    }
    del rec["ifr_unused"]
    df = pd.DataFrame(rec, index=idx)
    for k in range(3):
        rows = (k + 1) * days // 3
        if step_callback and not step_callback(df.iloc[:rows]):
            from reina_tpu.core.engine import ExecutionInterrupted
            raise ExecutionInterrupted()
        time.sleep(0.7)
    return df, None


fake_simulate._calcfunc_variables = ["random_seed", "area_name",
                                     "simulation_days"]
fake_simulate._calcfunc_funcs = []
fake_simulate._calcfunc_filedeps = []


def main() -> None:
    from reina_tpu.runtime import runner
    runner.simulate_individuals = fake_simulate
    from reina_tpu.runtime.graphql import server
    server.serve(port=int(os.environ.get("PORT", 5099)), warmup=False)


if __name__ == "__main__":
    main()
