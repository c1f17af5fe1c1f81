"""Compartmental SIR comparison model (reference: calc/sir.py).

The reference integrates a 3-compartment ODE with scipy ``solve_ivp``
on the host; here it is a jitted RK4 integrator under ``lax.scan`` so
sanity-comparison sweeps (e.g. a grid over R0) run vmapped on the
device next to the agent-based engine. The reference's driving variables
(``r0``, ``initial_infected``, ``infectious_days``) had rotted out of
its defaults (calc/sir.py:24 vs variables.py); they are explicit
arguments here.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(4,))
def simulate_sir(population, initial_infected, r0, infectious_days,
                 days: int, steps_per_day: int = 4):
    """Integrate S/I/R; returns (days, 3) array of compartment counts.

    dS = -beta·S·I/N ; dI = beta·S·I/N - gamma·I ; dR = gamma·I
    with gamma = 1/infectious_days, beta = R0·gamma.
    """
    n = population
    gamma = 1.0 / infectious_days
    beta = r0 * gamma
    dt = 1.0 / steps_per_day

    def deriv(y):
        s, i, _r = y
        inf = beta * s * i / n
        rec = gamma * i
        return jnp.array([-inf, inf - rec, rec])

    def rk4(y, _):
        def substep(y, _):
            k1 = deriv(y)
            k2 = deriv(y + dt / 2 * k1)
            k3 = deriv(y + dt / 2 * k2)
            k4 = deriv(y + dt * k3)
            return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4), None
        y, _ = jax.lax.scan(substep, y, None, length=steps_per_day)
        return y, y

    y0 = jnp.array([n - initial_infected, initial_infected, 0.0])
    _, ys = jax.lax.scan(rk4, y0, None, length=days)
    return jnp.concatenate([y0[None], ys[:-1]], axis=0)


def sweep_r0(population, initial_infected, r0_grid, infectious_days,
             days: int):
    """vmapped R0 grid — the calibration-sweep building block."""
    fn = lambda r0: simulate_sir(population, initial_infected, r0,
                                 infectious_days, days)
    return jax.vmap(fn)(jnp.asarray(r0_grid))
