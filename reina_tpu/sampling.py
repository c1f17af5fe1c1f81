"""Parameter-distribution sampling (reference: main.pyx:2047-2101 +
calc/simulation.py:301-346): 10k draws from the model's stochastic
primitives for the parameter-explorer UI.

Draws run through the ENGINE's own jax samplers — the severity chain
(`core.step._severity_draw_slots`), the fixed-round gamma
(`ops.random.gamma_fixed`) and the contact-count expression from the
exposure phase — exactly as the reference's ``context.sample`` draws
through the live simulation code (main.pyx:2047-2101), so the explorer
cannot drift from the step. The programs are tiny and pinned to the CPU
backend so a serving process never waits on an accelerator compile.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from .core import constants as C
from .core.params import compile_disease, create_disease_params
from .data import loaders

SAMPLE_SIZE = 10000

SUPPORTED = {
    "infectiousness", "contacts_per_day", "symptom_severity",
    "incubation_period", "illness_period", "hospitalization_period",
    "icu_period", "onset_to_removed_period",
}


def _cpu_device():
    import jax
    return jax.devices("cpu")[0]


def _gamma_engine(key, mu: float, cv: float):
    """The engine's duration draw: fixed-round standard gamma scaled by
    theta (core/step.py slot_pipeline)."""
    import jax.numpy as jnp

    from .ops.random import gamma_fixed

    kappa = 1.0 / (cv ** 2)
    theta = (cv ** 2) * mu
    return np.asarray(gamma_fixed(key, kappa, (SAMPLE_SIZE,))) * theta


def sample_distribution(what: str, age: int, severity: Optional[str],
                        variables: Dict):
    if what not in SUPPORTED:
        raise ValueError(
            "unknown sample type. supported: %s" % ", ".join(sorted(SUPPORTED)))
    # explorer draws dispatch small scans eagerly; keep their executables
    # out of the on-disk compile cache — deserializing such an entry
    # after many in-process compiles segfaults XLA:CPU
    # (utils/compile.py:persistent_cache_disabled), and sub-second
    # compiles gain nothing from caching
    from .utils.compile import persistent_cache_disabled
    with persistent_cache_disabled():
        return _sample_distribution(what, age, severity, variables)


def _sample_distribution(what: str, age: int, severity: Optional[str],
                         variables: Dict):
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    nr_ages = variables["max_age"] + 1
    disease, _names = compile_disease(create_disease_params(variables), nr_ages)
    sev = C.STR_TO_SEVERITY[severity] if severity else C.MILD

    if what == "infectiousness":
        days = np.arange(-C.IOT_OFFSET, C.IOT_OFFSET + 1)
        s = pd.Series(index=days, data=np.array(C.INFECTIOUSNESS_OVER_TIME))
        return s[s != 0].sort_index()

    with jax.default_device(_cpu_device()):
        key = jr.PRNGKey(variables.get("random_seed", 0))
        if what == "contacts_per_day":
            contacts = loaders.get_contact_tensor()
            base = contacts.per_year_participant(variables["max_age"])
            limit_mob = variables.get("sample_limit_mobility", 0)
            mob = (100 - limit_mob) / 100.0
            mean_contacts = float(base[age].sum()) * mob
            # exposure-phase expression (core/step.py phase 4)
            z = jr.normal(key, (SAMPLE_SIZE,), jnp.float32)
            f = jnp.exp(C.CONTACT_LOGNORMAL_SIGMA * z) * mean_contacts
            f = jnp.maximum(f, 1.0)
            out = np.asarray(jnp.clip(
                jnp.floor(f).astype(jnp.int32) - 1, 0,
                C.DEFAULT_CONTACT_LIMIT))
        elif what == "symptom_severity":
            from .core.step import _severity_draw_slots
            disease_j = type(disease)(*(jnp.asarray(t) for t in disease))
            v_i = jnp.zeros(SAMPLE_SIZE, jnp.int32)
            age_i = jnp.full(SAMPLE_SIZE, age, jnp.int32)
            dov_i = jnp.full(SAMPLE_SIZE, -1, jnp.int16)
            sev_i, _outside = _severity_draw_slots(
                key, disease_j, v_i, age_i, dov_i, jnp.int32(0))
            out = np.asarray(sev_i).astype(np.int64)
        elif what == "incubation_period":
            g = _gamma_engine(key, float(disease.mu_incub[0]),
                              C.INCUBATION_CV)
            out = np.floor(g + 0.5).astype(np.int64)
        else:
            mu = (disease.mu_death[0] if sev == C.FATAL
                  else disease.mu_recov[0])
            o2r = _gamma_engine(key, float(mu), C.ONSET_TO_REMOVED_CV)
            rb = float(disease.ratio_before_hosp[0])
            rw = float(disease.ratio_in_ward[0])
            if what == "onset_to_removed_period":
                out = np.floor(o2r + 0.5).astype(np.int64)
            elif what == "illness_period":
                ratio = rb if sev >= C.SEVERE else 1.0
                out = np.floor(o2r * ratio + 0.5).astype(np.int64)
            elif what == "hospitalization_period":
                ratio = (1 - rb) if sev == C.SEVERE else (
                    rw if sev >= C.CRITICAL else 0.0)
                out = np.floor(o2r * ratio + 0.5).astype(np.int64)
            elif what == "icu_period":
                ratio = (1 - rw - rb) if sev >= C.CRITICAL else 0.0
                out = np.floor(o2r * ratio + 0.5).astype(np.int64)

    s = pd.Series(out)
    c = s.value_counts().sort_index()
    if what == "symptom_severity":
        c.index = c.index.map(C.SEVERITY_TO_STR)
    return c
