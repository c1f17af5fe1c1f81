"""Test env: CPU backend with 8 virtual devices (multi-device tests run
on a host-device mesh — no accelerator needed)."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# the suite runs on the CPU backend whatever devices the host has
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Per-host-CPU cache subdirectory: the repo's .jax_cache travels across
# heterogeneous machines, and loading another machine's XLA:CPU AOT
# executables segfaults (see utils/compile.host_cpu_fingerprint).
from reina_tpu.utils.compile import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def tiny_run():
    from reina_tpu.testing import build_synthetic_run
    return build_synthetic_run(
        n_agents=20000, days=25, seed=3,
        interventions=[
            ["test-all-with-symptoms", "2020-02-20"],
            ["import-infections", "2020-02-20", 50],
            ["import-infections-weekly", "2020-02-25", 35],
            ["limit-mobility", "2020-03-01", 30],
            ["wear-masks", "2020-03-05", 50],
            ["test-with-contact-tracing", "2020-03-05", 60],
            ["vaccinate", "2020-03-01", 700, 60, None],
            ["build-new-icu-units", "2020-03-03", 5],
            ["build-new-hospital-beds", "2020-03-03", 20],
        ],
        pad_multiple=256)


@pytest.fixture(scope="session")
def tiny_result(tiny_run):
    from reina_tpu.core.engine import run_days
    out, state, carry, times = run_days(tiny_run, chunk_days=8)
    return out, state, carry
