"""Command-line interface (reference: ``python -m calc.simulation`` main,
calc/simulation.py:388-469).

  python -m reina_tpu.cli simulate [--area HUS] [--days N] [--seed S]
  python -m reina_tpu.cli monte-carlo --scenario default --runs 1000
  python -m reina_tpu.cli sample --what symptom_severity --age 90
  python -m reina_tpu.cli calibrate --grid '{"infectiousness_multiplier": [0.4, 0.55, 0.7]}'
"""
from __future__ import annotations

import argparse
import sys


def _print_header():
    state_attrs = ["ct_cases_per_day"]
    from .simulation import POP_ATTRS
    header = "%-10s" % "day"
    for attr in POP_ATTRS + state_attrs + ["r", "exposures", "us_per_infected"]:
        header += "%15s" % attr
    print(header)


def _step_printer(df):
    rec = df.dropna().iloc[-1]
    from .simulation import POP_ATTRS
    s = "%-12s" % rec.name.date().isoformat()
    for attr in POP_ATTRS:
        s += "%15d" % rec[attr]
    s += "%15d" % rec["ct_cases_per_day"]
    s += "%13.2f" % rec["r"]
    contacts = sum(rec[x] for x in rec.index if "exposures_" in x)
    s += "%15d" % contacts
    s += "%13.2f" % rec["us_per_infected"]
    print(s)
    return True


def cmd_simulate(args):
    from .config import allow_set_variable, set_variable
    from .simulation import simulate_individuals

    with allow_set_variable():
        if args.area:
            set_variable("area_name", args.area)
        if args.days:
            set_variable("simulation_days", args.days)
        if args.seed is not None:
            set_variable("random_seed", args.seed)
        if args.scenario:
            from .config.scenarios import get_scenario
            get_scenario(args.scenario).apply()
        _print_header()
        df, adf = simulate_individuals(
            step_callback=_step_printer if not args.quiet else None,
            callback_day_interval=args.interval, skip_cache=True)
    if args.quiet:
        print(df.tail(10))
    print(adf)
    return 0


def cmd_monte_carlo(args):
    from .ensemble import run_monte_carlo
    df = run_monte_carlo(args.scenario, n_runs=args.runs,
                         batch_size=args.batch_size)
    print(df[df.date == df.date.max()].describe())
    return 0


def cmd_calibrate(args):
    import json

    from .calibration import calibrate
    from .config.variables import VariableStore

    store = VariableStore()
    variables = store.copy_all()
    if args.area:
        variables["area_name"] = args.area
    if args.days:
        variables["simulation_days"] = args.days
    grid = json.loads(args.grid)
    best, ranked = calibrate(variables, grid, batch_size=args.batch_size,
                             metric=args.metric)
    print("rank  score        point")
    for i, (pt, score) in enumerate(ranked):
        print("%-5d %-12.5f %s" % (i + 1, score, json.dumps(pt)))
    print("best:", json.dumps(best))
    return 0


def cmd_sample(args):
    from .simulation import sample_model_parameters
    c = sample_model_parameters(args.what, args.age, args.severity)
    total = c.sum()
    for k, v in (c / total).items():
        print("    (%s, %.4f)," % (k, v))
    return 0


def main(argv=None):
    from reina_tpu.utils.compile import enable_persistent_cache
    enable_persistent_cache()
    ap = argparse.ArgumentParser(prog="reina_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd")

    p = sub.add_parser("simulate", help="run one simulation, print daily table")
    p.add_argument("--area", default=None)
    p.add_argument("--days", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--scenario", default=None)
    p.add_argument("--interval", type=int, default=1)
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("monte-carlo", help="vmapped Monte-Carlo ensemble")
    p.add_argument("--scenario", default="default")
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1,
                   help="vmapped seed batch; 1 = sequential runs through "
                        "the single-run program")
    p.set_defaults(func=cmd_monte_carlo)

    p = sub.add_parser(
        "calibrate",
        help="vmapped parameter-grid sweep scored against observed data")
    p.add_argument("--grid", required=True,
                   help='JSON, e.g. {"infectiousness_multiplier": [0.4, 0.55, 0.7]}')
    p.add_argument("--area", default=None)
    p.add_argument("--days", type=int, default=None)
    p.add_argument("--metric", default="all_detected",
                   choices=["all_detected", "dead"])
    p.add_argument("--batch-size", type=int, default=8)
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser("sample", help="sample model parameter distributions")
    p.add_argument("--what", required=True)
    p.add_argument("--age", type=int, default=30)
    p.add_argument("--severity", default=None)
    p.set_defaults(func=cmd_sample)

    args = ap.parse_args(argv)
    if not args.cmd:
        ap.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
