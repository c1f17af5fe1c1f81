"""The day step's plain XLA forms against numpy references, at widths
that are not multiples of 1024 and with out-of-range codes; the
dart-success contraction's precision; the compile-cache rule; and the
start-up contract of chip_smoke.py and bench.py off the GPU."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reina_tpu.ops.clamped import clamped_counter_grants
from reina_tpu.ops.compact import concat_cumsum
from reina_tpu.ops.histogram import bihistogram, onehot_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1000, 2048, 4097])
def test_onehot_counts_matches_bincount(n):
    rng = np.random.default_rng(n)
    K, B = 5, 11
    parts = rng.random((K, n)) < 0.3
    code = rng.integers(-2, B + 2, n)            # incl. out-of-range
    got = np.asarray(onehot_counts([jnp.asarray(p) for p in parts],
                                   jnp.asarray(code), B))
    ok = (code >= 0) & (code < B)
    want = np.stack([np.bincount(code[ok & p], minlength=B)
                     for p in parts])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_onehot_counts_of_output_masks():
    """Phase 7's form: masks derived from raw 8/16-bit fields."""
    n, B = 3001, 9
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.random(n) < 0.4)
    v = jnp.asarray(rng.integers(-3, 40, n).astype(np.int16))
    code = jnp.asarray(rng.integers(0, B, n))
    vi = v.astype(jnp.int32)
    masks = [a & (vi >= 0), (vi >= 10) & ~a]
    got = np.asarray(onehot_counts(masks, code, B))
    want = np.stack([np.bincount(np.asarray(code)[np.asarray(m)],
                                 minlength=B) for m in masks])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [999, 4096, 5003])
def test_bihistogram_matches_add_at(n):
    rng = np.random.default_rng(n)
    A, B = 7, 13
    ca = rng.integers(-1, A + 1, n)              # both ends out of range
    cb = rng.integers(-1, B + 1, n)
    w = rng.integers(0, 129, n).astype(np.float32)
    got = np.asarray(bihistogram(jnp.asarray(ca), A, jnp.asarray(w),
                                 jnp.asarray(cb), B))
    want = np.zeros((A, B))
    ok = (ca >= 0) & (ca < A) & (cb >= 0) & (cb < B)
    np.add.at(want, (ca[ok], cb[ok]), w[ok])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_seg", [(1000, 1), (1000, 2), (4096, 3),
                                     (5003, 2)])
def test_concat_cumsum_matches_numpy(n, n_seg):
    rng = np.random.default_rng(n + n_seg)
    w = (rng.random(n) * 3).astype(np.float32)
    codes = rng.integers(0, n_seg, n).astype(np.int32)
    ref = np.cumsum(np.concatenate(
        [np.where(codes == s, w.astype(np.float64), 0.0)
         for s in range(n_seg)]))
    got = np.asarray(concat_cumsum(jnp.asarray(w), jnp.asarray(codes),
                                   n_seg))
    assert got.shape == (n_seg * n,)
    assert np.abs(got - ref).max() / ref[-1] < 1e-6
    # integer-valued weights are exact under any summation order
    wi = np.floor(w * 10)
    got_i = np.asarray(concat_cumsum(jnp.asarray(wi), jnp.asarray(codes),
                                     n_seg))
    np.testing.assert_array_equal(got_i, np.cumsum(np.concatenate(
        [np.where(codes == s, wi, 0) for s in range(n_seg)])))


def _sequential(releases, requests, init, offset):
    n = len(releases)
    bal, granted = int(init), np.zeros(n, bool)
    for i in range(n):
        p = (offset + i) % n
        bal += int(releases[p])
        if requests[p] and bal > 0:
            bal -= 1
            granted[p] = True
    return granted, bal


@pytest.mark.parametrize("n_ledgers", [1, 2])
@pytest.mark.parametrize("where", ["zero", "one", "mid", "last"])
def test_ledger_matches_sequential_at_offsets(n_ledgers, where):
    n = 1237                                     # not a multiple of 1024
    offset = {"zero": 0, "one": 1, "mid": n // 2, "last": n - 1}[where]
    rng = np.random.default_rng(n_ledgers * 10 + offset)
    rel = rng.integers(0, 2, (n_ledgers, n)).astype(np.int32)
    req = rng.random((n_ledgers, n)) < 0.35
    init = rng.integers(0, 6, n_ledgers).astype(np.int32)
    granted, final = clamped_counter_grants(
        [jnp.asarray(r) for r in rel], [jnp.asarray(q) for q in req],
        jnp.asarray(init), jnp.int32(offset))
    for led in range(n_ledgers):
        want_g, want_b = _sequential(rel[led], req[led], init[led], offset)
        np.testing.assert_array_equal(np.asarray(granted[led]), want_g)
        assert int(np.asarray(final)[led]) == want_b


def test_dart_success_asks_for_highest_precision():
    """The float32 contraction must not run in TF32 on a GPU: its jaxpr
    carries Precision.HIGHEST."""
    from reina_tpu.core.step import dart_success
    A, P, B, V = 4, 3, 2, 2
    jaxpr = jax.make_jaxpr(dart_success)(
        jnp.ones((A, P, B)), jnp.zeros((V, A, P)), jnp.ones((V, B)))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, jaxpr
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_chip_smoke_op_checks_pass_at_small_width():
    """chip_smoke's op phase, against its numpy references, on a small
    synthetic population (no engine program is compiled)."""
    from reina_tpu.testing import build_synthetic_run
    cs = _load_chip_smoke()
    run = build_synthetic_run(n_agents=3000, days=3, pad_multiple=256)
    cs.check_ops(run, "cpu", time_ops=False)


def test_chip_smoke_first_difference():
    from reina_tpu.core.step import DayOutputs
    cs = _load_chip_smoke()
    days = 5

    def outs(r):
        return DayOutputs(*(np.zeros((days, 2), np.int32)
                            for _ in DayOutputs._fields))._replace(
            r=np.asarray(r, np.float32))

    base = outs(np.zeros((days, 2)))
    assert cs.first_difference(base, base) is None
    later = np.zeros((days, 2))
    later[3, 1] = 1.0
    assert cs.first_difference(base, outs(later)) == (3, "r")


def _run(args, env_extra, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(env_extra)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_needs_a_gpu(script):
    r = _run([os.path.join(REPO, script)], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "'cpu'" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, cwd=tmp_path)
    assert r.returncode != 0
    assert "reina_tpu" in r.stderr
    assert '"ok"' not in r.stdout


_PRINT_CACHE_DIR = ("import jax, reina_tpu; "
                    "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("platforms,env_set", [
    ("cpu", True), ("cuda", True), ("cuda", False), ("cpu", False)])
def test_compile_cache_dir_rule(platforms, env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as given; unset, the cache is
    <checkout>/.jax_cache, with a per-host-CPU subdirectory only for
    the CPU platform. (Importing reina_tpu initializes no backend, so
    JAX_PLATFORMS=cuda needs no GPU here.)"""
    extra = {"JAX_PLATFORMS": platforms}
    env_dir = str(tmp_path / "cache") if env_set else None
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = _run(["-c", _PRINT_CACHE_DIR], extra)
    assert r.returncode == 0, r.stderr
    got = r.stdout.strip().splitlines()[-1]
    root = os.path.join(REPO, ".jax_cache")
    if env_dir:
        assert got == env_dir
    elif platforms == "cpu":
        assert os.path.dirname(got) == root
        assert os.path.basename(got).startswith("cpu-")
    else:
        assert got == root


def test_engine_import_needs_no_pandas():
    r = _run(["-c", "import sys, reina_tpu.core.engine, reina_tpu.ensemble;"
                    " print('pandas' in sys.modules)"],
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"
