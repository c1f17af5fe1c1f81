"""Multi-host (multi-process) smoke test: two OS processes, a
coordinator, and an agent-axis mesh that SPANS the processes — the
CPU stand-in for a mesh whose agent axis crosses hosts (reference scale-out: one OS process per ensemble member,
calc/simulation.py:376-377).

Each child process forces the CPU backend with exactly ONE local
device, so the 2-device 'agent' mesh axis necessarily crosses the
process boundary and every dart-reduction / ledger collective in the
day step rides the distributed runtime.
"""
import os
import socket
import subprocess
import sys

import pytest

_CHILD = """
import jax
jax.config.update("jax_platforms", "cpu")

from reina_tpu.parallel.mesh import init_distributed, make_mesh

n = init_distributed()
assert n == 2, f"process_count {n}"
assert jax.process_count() == 2
assert len(jax.devices()) == 2, jax.devices()
assert len(jax.local_devices()) == 1, jax.local_devices()

mesh = make_mesh(n_seed=1, n_agent=2)

from reina_tpu.core.engine import run_days
from reina_tpu.testing import build_synthetic_run

run = build_synthetic_run(n_agents=2000, days=3, seed=1, pad_multiple=1024)
out, state, carry, _ = run_days(run, n_days=3, chunk_days=2, mesh=mesh)

import numpy as np
tot = int(np.asarray(out.by_group).sum())
assert out.by_group.shape[0] == 3
print("MULTIHOST_OK", tot, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_agent_sharded_run(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        # exactly one local CPU device per process: the mesh's agent
        # axis must cross the process boundary
        env.pop("XLA_FLAGS", None)
        env.update({
            "REINA_COORDINATOR": f"127.0.0.1:{port}",
            "REINA_NUM_PROCESSES": "2",
            "REINA_PROCESS_ID": str(pid),
            "PYTHONPATH": repo,
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"process {pid} output:\n{out}"

    # both processes computed the same replicated outputs
    tot0 = outs[0].split("MULTIHOST_OK")[1].split()[0]
    tot1 = outs[1].split("MULTIHOST_OK")[1].split()[0]
    assert tot0 == tot1, (tot0, tot1)
