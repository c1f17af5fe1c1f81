"""Compilation helpers: the persistent compile cache and ``engine_jit``."""
from __future__ import annotations

import contextlib
import functools
import os

import jax

# <checkout>/.jax_cache: a fixed path, so the cache's keys stay valid
# from one process to the next
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def host_cpu_fingerprint() -> str:
    """Short digest of the host CPU's feature set. XLA:CPU cache
    entries are AOT machine code compiled for the build host's exact
    features; jax's cache key does NOT include them, so a cache
    directory shared across heterogeneous machines serves foreign
    executables whose load SIGILLs/segfaults (observed: cpu_aot_loader
    'machine type ... doesn't match' warnings, then a segfault inside
    get_executable_and_time mid-suite)."""
    import hashlib
    import platform
    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            got_flags = got_model = False
            for line in f:
                # the model name too, not just the flags: LLVM applies
                # model-derived TUNING (e.g. +prefer-no-scatter) that
                # two hosts with identical cpuinfo flags may not share
                if line.startswith("flags") and not got_flags:
                    feat += " ".join(sorted(line.split(":", 1)[1].split()))
                    got_flags = True
                elif line.startswith("model name") and not got_model:
                    feat += line.split(":", 1)[1].strip()
                    got_model = True
                if got_flags and got_model:
                    break
    except OSError:
        pass
    return hashlib.sha256(feat.encode()).hexdigest()[:10]


def cache_dir_for_process() -> str:
    """Where this process keeps its persistent compile cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as given. Otherwise
    the cache lives at ``<checkout>/.jax_cache``; a process forced onto
    the CPU platform (tests, dry runs) uses a per-host-CPU subdirectory
    of it — see ``host_cpu_fingerprint``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.config.jax_platforms == "cpu":
        return os.path.join(DEFAULT_CACHE_DIR,
                            "cpu-%s" % host_cpu_fingerprint())
    return DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Point jax's persistent compilation cache at
    :func:`cache_dir_for_process` so later processes (bench, CLI,
    server, tests) skip compiles of the same programs. Safe to call more
    than once; returns the directory used."""
    cache_dir = cache_dir_for_process()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def engine_jit(fn=None, *, static_argnums=(), no_persistent_cache=False):
    """``jax.jit`` for the engine's programs.

    ``no_persistent_cache=True`` keeps this program out of the on-disk
    compilation cache: serializing/deserializing the large vmapped
    ensemble executable segfaults inside the XLA CPU client when the
    process has compiled many other programs first (reproduced 3× in
    the full test suite at both the cache-put and cache-get paths; the
    identical program round-trips fine in a fresh process). The flag is
    flipped around every call (any call with a new arg shape compiles),
    so every other program keeps the warm-start cache."""
    if fn is None:
        return functools.partial(engine_jit, static_argnums=static_argnums,
                                 no_persistent_cache=no_persistent_cache)

    jitted = jax.jit(fn, static_argnums=static_argnums)
    if not no_persistent_cache:
        return jitted

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with persistent_cache_disabled():
            return jitted(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def persistent_cache_disabled():
    """Disable the on-disk compilation cache (reads AND writes) for the
    calls under the context.

    Flipping ``jax_enable_compilation_cache`` alone is NOT enough:
    ``compilation_cache.is_cache_used`` memoizes its verdict after the
    first cached compile in the process, after which cache keys are
    produced and the GET path deserializes entries regardless of the
    flag. ``reset_cache()`` clears that memoization (and the cache
    object) so the flag is genuinely re-consulted; a second reset on
    exit lets later compiles re-initialize the cache normally. This
    matters because XLA:CPU segfaults inside executable
    (de)serialization after enough cumulative compiles in one process
    (reproduced at a cache GET of a small eager-dispatched sampler
    scan ~100 tests in, and at the 4th+ big vmapped-engine compile) —
    keep fragile or cache-worthless programs out entirely."""
    from jax._src import compilation_cache

    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
        compilation_cache.reset_cache()
