"""Mesh construction and sharding layouts.

The reference's parallelism is OS processes: an 8-way multiprocessing
pool for Monte-Carlo ensembles (calc/simulation.py:376-377) and a
process per serving request (graphql_schema.py:393-399). Here both axes
are device-mesh dimensions:

  * ``seed``  — embarrassingly parallel ensemble members (the reference's
                pool.map axis) ≙ data parallel
  * ``agent`` — the population axis *within* one simulation, sharded
                across devices ≙ the tensor/sequence-parallel axis; the
                cross-shard traffic (dart-count reductions, the capacity
                ledgers' scans, the new-infection exchange) is made of
                collectives that XLA inserts from these sharding
                annotations.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize the multi-host (multi-process) runtime for meshes that
    span hosts.

    Call once per process before any device access. Pass the
    coordinator's ``host:port`` plus this process's id and the world
    size, or set ``REINA_COORDINATOR`` / ``REINA_NUM_PROCESSES`` /
    ``REINA_PROCESS_ID``.

    After initialization ``jax.devices()`` is the GLOBAL device list —
    pass it to :func:`make_mesh` and keep the ``seed`` (data-parallel)
    axis as the slow, inter-host dimension so its rare collectives
    cross hosts while the chatty ``agent``-axis reductions stay within
    one: ``make_mesh(n_seed=n_hosts, n_agent=devices_per_host)``.

    Single-process runs (no coordinator configured) are a no-op.
    Returns the number of participating processes.
    """
    import os

    coordinator_address = coordinator_address or os.environ.get(
        "REINA_COORDINATOR")
    if coordinator_address is None:
        return 1
    if num_processes is None and os.environ.get("REINA_NUM_PROCESSES"):
        num_processes = int(os.environ["REINA_NUM_PROCESSES"])
    if process_id is None and os.environ.get("REINA_PROCESS_ID"):
        process_id = int(os.environ["REINA_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count()


def make_mesh(n_seed: Optional[int] = None, n_agent: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (seed × agent) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_seed is None and n_agent is None:
        n_agent = 1
        n_seed = n
    elif n_seed is None:
        n_seed = n // n_agent
    elif n_agent is None:
        n_agent = n // n_seed
    assert n_seed * n_agent == n, (n_seed, n_agent, n)
    dev_grid = np.asarray(devices).reshape(n_seed, n_agent)
    return Mesh(dev_grid, ("seed", "agent"))


def _agent_placement(mesh: Mesh, n: int):
    def placement(x):
        if hasattr(x, "shape") and np.ndim(x) >= 1 and x.shape[0] == n:
            spec = P("agent", *([None] * (np.ndim(x) - 1)))
        elif (hasattr(x, "shape") and np.ndim(x) == 1
              and x.shape[0] > n and x.shape[0] % n == 0):
            # the flat (N·CAPB,) infectee-bucket table: contiguous
            # agent-axis split keeps whole per-source rows on one shard
            spec = P("agent")
        elif (hasattr(x, "shape") and np.ndim(x) >= 2
              and x.shape[1] == n):
            # (V, N) per-agent tables (lam_log1p_ag): shard the agent
            # axis, replicate the small leading axis — otherwise each
            # chip holds the full table and GSPMD reshards it every day
            spec = P(None, "agent", *([None] * (np.ndim(x) - 2)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return placement


def place_state_carry(mesh: Mesh, state, carry):
    """Agent-shard an AgentState and replicate a DayCarry on ``mesh``
    (used both for fresh runs and checkpoint resume)."""
    n = state.age.shape[0]
    placement = _agent_placement(mesh, n)
    state = jax.tree.map(placement, state)
    # the carry is replicated except its (N,)-shaped leaves (the cached
    # nc_ag expansion), which _agent_placement shards like agent state
    carry = jax.tree.map(placement, carry)
    return state, carry


def shard_run(run, mesh: Mesh):
    """Place a CompiledRun's arrays for agent-axis sharding: (N,)-shaped
    model/state arrays split over 'agent', everything else replicated."""
    n = run.init_state.age.shape[0]
    arrays = jax.tree.map(_agent_placement(mesh, n), run.arrays)
    state, carry = place_state_carry(mesh, run.init_state, run.init_carry)
    schedules = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), run.schedules)
    return arrays, schedules, state, carry


def batch_placement(mesh: Mesh, n_agents: int):
    """Sharding rule for seed-batched pytrees: (S, N, ...) → seed × agent,
    (S, ...) → seed, rest replicated."""
    def placement(x):
        if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[1] == n_agents:
            spec = P("seed", "agent", *([None] * (x.ndim - 2)))
        elif hasattr(x, "ndim") and x.ndim >= 1:
            spec = P("seed", *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return NamedSharding(mesh, spec)
    return placement
