"""Time-to-first-partial for a fresh run through the REAL GraphQL path.

Starts the production server in-process (with the serving-program
warm-up), POSTs runSimulation over HTTP, and polls simulationResults at
the client's 0.5 s cadence, recording when the phase leaves
"compiling", when the first non-empty partial arrives, and when the run
finishes. The JSON line it prints names the device and, on a GPU, the
card and its power limit.

Usage: python tools/measure_serving_latency.py [--days N] [--no-warmup]
"""
import json
import os
import subprocess
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gql(port, query, cookie=None):
    body = json.dumps({"query": query}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/graphql", data=body,
        headers={"Content-Type": "application/json",
                 **({"Cookie": cookie} if cookie else {})})
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = json.loads(resp.read())
        set_cookie = resp.headers.get("Set-Cookie", "")
    if out.get("errors"):
        raise RuntimeError(out["errors"])
    return out["data"], set_cookie.split(";")[0] if set_cookie else cookie


def main() -> None:
    days = 365
    warmup = True
    for a in sys.argv[1:]:
        if a.startswith("--days="):
            days = int(a.split("=")[1])
        elif a == "--no-warmup":
            warmup = False

    from reina_tpu.runtime.graphql import server

    t0 = time.perf_counter()
    if warmup:
        server.warmup_serving_program()
        print(f"warm-up: {time.perf_counter() - t0:.1f}s", flush=True)
    httpd = server.serve(host="127.0.0.1", port=0, background=True,
                         warmup=False)
    port = httpd.server_address[1]
    try:
        cookie = None
        if days != 565:
            _, cookie = gql(port, "mutation { resetVariables { ok } }")
            _, cookie = gql(
                port, "mutation { setSimulationDays(days: %d) { ok } }"
                % days, cookie)
        t0 = time.perf_counter()
        d, cookie = gql(port, "mutation { runSimulation { runId } }",
                        cookie)
        run_id = d["runSimulation"]["runId"]
        first_partial = first_running = finished = None
        while time.perf_counter() - t0 < 3600:
            time.sleep(0.5)
            d, cookie = gql(
                port,
                '{ simulationResults(runId: "%s") { finished phase '
                'predictedMetrics { dates } } }' % run_id, cookie)
            res = d["simulationResults"]
            now = time.perf_counter() - t0
            if first_running is None and res["phase"] != "compiling":
                first_running = now
            if first_partial is None and res["predictedMetrics"]["dates"]:
                first_partial = now
            if res["finished"]:
                finished = now
                break
        import jax
        dev = jax.devices()[0]
        card = (subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.splitlines()[0]
            if dev.platform == "gpu" else None)
        print(json.dumps({
            "metric": "serving_time_to_first_partial_s",
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "days": days,
            "warmed_up": warmup,
            "first_non_compiling_phase_s": round(first_running or -1, 2),
            "first_partial_s": round(first_partial or -1, 2),
            "finished_s": round(finished or -1, 2),
        }))
    finally:
        httpd.shutdown()


if __name__ == "__main__":
    main()
