"""Run orchestration: dedup, streaming, admission control, cancellation."""
import threading
import time

import pandas as pd
import pytest

from reina_tpu.runtime import cache, runner


@pytest.fixture(autouse=True)
def fresh_cache():
    cache.init_backend("memory")
    yield


@pytest.fixture
def fake_sim(monkeypatch):
    """Replace the simulation with a quick fake that streams 3 rows."""
    calls = {"n": 0}

    def fake(step_callback=None, callback_day_interval=1, variable_store=None):
        calls["n"] += 1
        idx = pd.date_range("2020-02-18", periods=3)
        df = pd.DataFrame({"infected": [1, 2, 3]}, index=idx)
        for i in range(3):
            if step_callback and not step_callback(df.iloc[:i + 1]):
                from reina_tpu.core.engine import ExecutionInterrupted
                raise ExecutionInterrupted()
            time.sleep(0.01)
        return df, df

    fake._calcfunc_variables = ["random_seed", "area_name"]
    fake._calcfunc_funcs = []
    fake._calcfunc_filedeps = []
    monkeypatch.setattr(runner, "simulate_individuals", fake)
    return calls


def test_run_and_stream(fake_sim):
    reg = runner.RunRegistry()
    run_id = reg.start_run({"random_seed": 1})
    t = reg.get(run_id)
    assert t is not None
    t.join(timeout=10)
    assert cache.get("%s-finished" % run_id) is True
    assert cache.get("%s-error" % run_id) is None
    res = cache.get("%s-results" % run_id)
    assert res is not None and len(res["total"]) == 3
    assert res["age_groups"] is not None


def test_dedup_same_variables(fake_sim):
    reg = runner.RunRegistry()
    r1 = reg.start_run({"random_seed": 7})
    live = reg.get(r1)
    r2 = reg.start_run({"random_seed": 7})
    assert r1 == r2  # deterministic run identity
    # the duplicate's thread never started — the LIVE thread must stay
    # registered so reap()/cancel still reach it
    assert reg.get(r1) is live
    r3 = reg.start_run({"random_seed": 8})
    assert r3 != r1


def test_admission_control(fake_sim, monkeypatch):
    reg = runner.RunRegistry(max_runs=2)
    # block workers so they stay alive
    gate = threading.Event()

    def slow(step_callback=None, callback_day_interval=1, variable_store=None):
        gate.wait(timeout=5)
        idx = pd.date_range("2020-02-18", periods=1)
        df = pd.DataFrame({"infected": [1]}, index=idx)
        return df, df

    slow._calcfunc_variables = ["random_seed"]
    slow._calcfunc_funcs = []
    slow._calcfunc_filedeps = []
    monkeypatch.setattr(runner, "simulate_individuals", slow)

    reg.start_run({"random_seed": 100})
    reg.start_run({"random_seed": 101})
    with pytest.raises(runner.BusyError):
        reg.start_run({"random_seed": 102})
    gate.set()


def test_heartbeat_outlives_ttl(monkeypatch):
    """The worker refreshes ``-finished``/``-results`` while the engine
    is stuck in a long XLA compile and cannot publish — otherwise the
    30 s key TTL expires mid-compile and clients see "No simulation run
    active" (reference simulation_thread.py:20,41 assumed sub-TTL
    days; a cold compile of our day chunk exceeds it)."""
    monkeypatch.setattr(runner, "HEARTBEAT_S", 0.05)
    gate = threading.Event()

    def stuck(step_callback=None, callback_day_interval=1,
              variable_store=None):
        idx = pd.date_range("2020-02-18", periods=1)
        df = pd.DataFrame({"infected": [1]}, index=idx)
        step_callback(df)          # one early partial publish
        gate.wait(timeout=10)      # then a "compile" longer than the TTL
        return df, df

    stuck._calcfunc_variables = ["random_seed"]
    stuck._calcfunc_funcs = []
    stuck._calcfunc_filedeps = []
    monkeypatch.setattr(runner, "simulate_individuals", stuck)

    t = runner.SimulationThread({"random_seed": 99})
    t.cache_expiration = 0.2   # TTL ≪ the stall below
    t.start()
    run_id = t.cache_key
    time.sleep(1.0)  # ≫ TTL: without the heartbeat both keys expire
    assert cache.get("%s-finished" % run_id) is False
    assert cache.get("%s-results" % run_id) is not None
    gate.set()
    t.join(timeout=10)
    assert cache.get("%s-finished" % run_id) is True


def test_error_published(monkeypatch):
    def boom(step_callback=None, callback_day_interval=1, variable_store=None):
        raise RuntimeError("engine exploded")

    boom._calcfunc_variables = ["random_seed"]
    boom._calcfunc_funcs = []
    boom._calcfunc_filedeps = []
    monkeypatch.setattr(runner, "simulate_individuals", boom)
    reg = runner.RunRegistry()
    run_id = reg.start_run({"random_seed": 55})
    t = reg.get(run_id)
    t.join(timeout=10)
    assert cache.get("%s-finished" % run_id) is True
    assert "engine exploded" in cache.get("%s-error" % run_id)


def test_http_server_roundtrip():
    import json
    import urllib.request

    from reina_tpu.runtime.graphql.server import serve
    httpd = serve(host="127.0.0.1", port=0, background=True)
    port = httpd.server_address[1]
    try:
        body = json.dumps({"query": "{ area { name totalPopulation } }"}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/graphql", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            out = json.loads(resp.read())
            cookie = resp.headers.get("Set-Cookie", "")
        assert out["data"]["area"]["name"] == "HUS"
        assert "reina_session=" in cookie
    finally:
        httpd.shutdown()


def test_cors_not_reflected_with_credentials():
    """Unlisted origins get '*' WITHOUT credentials (flask-cors default
    in the reference); reflecting arbitrary origins with
    Allow-Credentials would grant any website credentialed API access."""
    import urllib.request

    from reina_tpu.runtime.graphql.server import serve
    httpd = serve(host="127.0.0.1", port=0, background=True)
    port = httpd.server_address[1]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/healthz",
            headers={"Origin": "https://evil.example"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            assert resp.headers.get("Access-Control-Allow-Credentials") is None
    finally:
        httpd.shutdown()


def test_xlsx_export_endpoint():
    """GET /export.xlsx serves the cached run's daily table as a real
    zip-of-SpreadsheetML workbook (reference dash_table Excel export,
    components/results.py:294-331)."""
    import io
    import urllib.request
    import urllib.error
    import zipfile
    from xml.etree import ElementTree

    import pandas as pd

    from reina_tpu.runtime import cache
    from reina_tpu.runtime.graphql.server import serve

    df = pd.DataFrame(
        {"all_detected": [1, 2], "dead": [0, 1], "r": [1.5, float("nan")]},
        index=pd.to_datetime(["2020-03-01", "2020-03-02"]))
    cache.set("xlsxtest-results", {"total": df, "age_groups": None})

    httpd = serve(host="127.0.0.1", port=0, background=True)
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/export.xlsx?run=xlsxtest",
                timeout=10) as resp:
            assert "spreadsheetml" in resp.headers["Content-Type"]
            data = resp.read()
        z = zipfile.ZipFile(io.BytesIO(data))
        names = set(z.namelist())
        assert {"[Content_Types].xml", "xl/workbook.xml",
                "xl/worksheets/sheet1.xml"} <= names
        ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
        sheet = ElementTree.fromstring(z.read("xl/worksheets/sheet1.xml"))
        sheet_rows = sheet.findall(f"{ns}sheetData/{ns}row")
        assert len(sheet_rows) == 3  # header + 2 days
        header = [c.find(f"{ns}is/{ns}t").text
                  for c in sheet_rows[0].findall(f"{ns}c")]
        assert header == ["date", "all_detected", "dead", "r"]
        day1 = sheet_rows[1].findall(f"{ns}c")
        assert day1[0].find(f"{ns}is/{ns}t").text == "2020-03-01"
        assert day1[1].find(f"{ns}v").text == "1"
        # NaN serializes as an empty cell, not an invalid number
        assert sheet_rows[2].findall(f"{ns}c")[3].find(f"{ns}v") is None

        # unknown run id → 404
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/export.xlsx?run=nope", timeout=10)
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        httpd.shutdown()


def test_shm_cache_backend():
    """Native shared-memory KV store: TTLs, cross-handle visibility,
    arena compaction (cpp/shmcache)."""
    import shutil
    if shutil.which("make") is None:
        pytest.skip("no native toolchain")
    from reina_tpu.runtime.shm import ShmKV
    try:
        ShmKV.unlink("reina-pytest")
    except Exception:
        pass
    kv = ShmKV("reina-pytest", 1 << 20)
    try:
        kv.set(b"a", b"hello", ttl=60)
        kv2 = ShmKV("reina-pytest", 1 << 20)
        assert kv2.get(b"a") == b"hello"
        kv.set(b"t", b"x", ttl=0.01)
        time.sleep(0.05)
        assert kv.get(b"t") is None
        # expired bulk entry is compacted away under arena pressure
        kv.set(b"big", b"z" * 100000, ttl=0.001)
        time.sleep(0.01)
        for i in range(30):
            kv.set(b"k%d" % i, b"v" * 20000)
        assert kv.get(b"k0") == b"v" * 20000
        assert kv.get(b"a") == b"hello"
        kv2.close()
    finally:
        kv.close()
        ShmKV.unlink("reina-pytest")


def test_shm_cache_delete_and_compaction_integrity():
    """Regressions for two shmcache bugs: (1) delete used to null the
    bucket (truncating open-addressing probe chains: colliding keys
    past the hole became unreachable — tombstones now keep chains
    alive), and (2) compaction repacked in bucket order, so a value
    could memmove DOWN onto a lower-offset live value that had not
    moved yet (now repacks in ascending offset order)."""
    import shutil
    if shutil.which("make") is None:
        pytest.skip("no native toolchain")
    from reina_tpu.runtime.shm import ShmKV
    try:
        ShmKV.unlink("reina-pytest-cc")
    except Exception:
        pass
    kv = ShmKV("reina-pytest-cc", 1 << 18)  # small: 16-bucket-scale table
    try:
        # interleave inserts and deletes so surviving keys sit behind
        # deleted slots in their probe chains (with a small table every
        # key collides), then verify every survivor stays reachable
        vals = {}
        for i in range(120):
            k = b"key-%03d" % i
            v = (b"%03d" % i) * (7 + i % 23)
            kv.set(k, v)
            vals[k] = v
            if i % 3 == 0 and i > 0:
                dk = b"key-%03d" % (i - 1)
                kv.delete(dk)
                del vals[dk]
        for k, v in vals.items():
            assert kv.get(k) == v, k
        # force repeated compactions with mixed value sizes and updates
        # (updates move a key's value to a high offset while its bucket
        # index stays put — the old repack order corrupted these)
        for rnd in range(6):
            for i in range(0, 120, 5):
                k = b"key-%03d" % i
                if k in vals:
                    vals[k] = bytes([65 + rnd]) * (50 + 37 * i % 1500)
                    kv.set(k, vals[k])
            kv.set(b"filler-%d" % rnd, b"f" * 60000, ttl=0.001)
            time.sleep(0.01)
            # second large short-lived value forces an arena compaction
            kv.set(b"press-%d" % rnd, b"p" * 60000, ttl=0.001)
            for k, v in vals.items():
                assert kv.get(k) == v, (rnd, k)
    finally:
        kv.close()
        ShmKV.unlink("reina-pytest-cc")


def test_shm_cache_interface():
    """ShmCache pickles arbitrary objects through the native store."""
    import shutil
    if shutil.which("make") is None:
        pytest.skip("no native toolchain")
    from reina_tpu.runtime.cache import ShmCache
    from reina_tpu.runtime.shm import ShmKV
    try:
        ShmKV.unlink("reina-cache")
    except Exception:
        pass
    c = ShmCache()
    c.set("run1-results", {"total": [1, 2, 3]}, timeout=30)
    assert c.get("run1-results") == {"total": [1, 2, 3]}
    assert c.get("missing") is None
    ShmKV.unlink("reina-cache")


def test_webui_run_poll_protocol():
    """The web UI's exact run→poll loop (runSimulation mutation, then
    the page's poll document at its cadence until finished) against the
    real worker/cache/GraphQL plumbing with a fast fake engine —
    asserts the phase transitions, monotonically growing partial
    frames, and that every metric the chart render() picks is present
    (tools/check_webui.check_protocol; round-4 verdict, weak #6)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from check_webui import check_protocol
    assert check_protocol() == []
