"""The vectorized day step: one simulated day as a single XLA program.

This is the vectorized replacement for the reference's serial nogil
sweep (main.pyx:1968-2009). Each phase is fully vectorized over the
agent axis:

  1. capacity builds + weekly-import accounting   (main.pyx:1671-1699)
  2. R_t bookkeeping over newly-removed agents    (main.pyx:1968-1972)
  3. testing-queue drain, detection, 2-level contact tracing,
     vaccination campaigns                        (main.pyx:514-593)
  4. exposure: group-aggregated transmission "darts" — per-source
     contact counts (lognormal), aggregated by (age, variant,
     infectiousness-day, asymptomatic) groups, binomially split across
     contact-age bands, then per-target infection trials by receiver
     thinning                                     (main.pyx:908-955, 1290-1320, 1539-1573)
  5. disease progression with exact sequential bed/ICU rationing via
     clamped-counter prefix scans                 (main.pyx:395-439, 617-648)
  6. merge of new infections (imports + contacts) with infector
     attribution                                  (main.pyx:209-245, 1652-1699)
  7. per-age-group statistics via one one-hot matmul
                                                  (main.pyx:1701-1744, 1813-1857)

Deviations from the serial reference are distributional-equivalence
preserving and documented in docs/parity.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from . import constants as C
from .state import AgentState, DayCarry
from ..ops.clamped import clamped_counter_grants
from ..ops.compact import compact_indices, concat_cumsum
from ..ops.histogram import bihistogram, onehot_counts
from ..ops.random import (binomial_fixed, gamma_fixed, searchsorted_compact,
                          searchsorted_fixed)

I32 = jnp.int32
F32 = jnp.float32


@dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs (hashable; passed as a static jit arg)."""
    infection_buffer: int = 1 << 16   # max new contact-infections per day
    infection_head: int = 1 << 9     # always-on buffer tier; the rest runs
    #                                  under lax.cond on high-incidence days
    #                                  (a 364-day HUS run's daily new-
    #                                  infection count has p50 = 75 and
    #                                  p75 = 845)
    import_buffer: int = 512          # max imported infections per day
    import_attempts: int = 10         # susceptible-search retries (main.pyx:1657)
    max_infectees: int = 64           # per-source infectee-bucket capacity —
    #                                   the reference's MAX_INFECTEES
    #                                   (main.pyx:128); overflow sets the
    #                                   TOO_MANY_INFECTEES problem like the
    #                                   reference (main.pyx:219-220)
    bucket_head: int = 4              # always-read bucket columns per
    #                                   tracing pass; deeper columns run in
    #                                   geometric tiers under lax.cond only
    #                                   when some queued source has that
    #                                   many infectees
    max_age_cohort: int = 1 << 16     # ≥ largest single-age population
    vacc_slots: int = 1               # vaccination campaign slots (≥ 1)
    nr_variants: int = 2
    nr_groups: int = 10               # output age groups (by_group rows)


class ModelArrays(NamedTuple):
    """All compiled static model data (device arrays)."""
    # population
    ages: jnp.ndarray            # (N,) int32 (widened for gathers)
    active: jnp.ndarray          # (N,) bool
    age_start: jnp.ndarray       # (A+1,) int32 — agent layout is age-sorted:
    #                              positions [age_start[a], age_start[a+1])
    #                              ARE the agents of age a (padding at tail)
    band_of_age: jnp.ndarray     # (A,) int32
    band_counts: jnp.ndarray     # (B,) int32
    group_of_agent: jnp.ndarray  # (N,) int32 — output age group (G = padding)
    active_per_group: jnp.ndarray  # (G,) int32 — static active counts
    #                                (phase 7 derives susceptible from it)
    # contacts
    contact_base: jnp.ndarray    # (A, P, B) float32
    # disease (leading axis = variant)
    p_susc: jnp.ndarray          # (V, A)
    sigma_max: jnp.ndarray       # (V, B)
    p_sympt: jnp.ndarray         # (V, A)
    p_severe_c: jnp.ndarray      # (V, A)
    p_critical_c: jnp.ndarray    # (V, A)
    p_fatal_c: jnp.ndarray       # (V, A)
    p_doh: jnp.ndarray           # (V, A)
    # per-agent static expansions (age/band are fixed per agent, so
    # every static age-indexed lookup is pre-expanded at build time)
    band_ag: jnp.ndarray         # (N,) int32 — contact band per agent
    lam_log1p_ag: jnp.ndarray    # (V, N) f32 — log1p(−σ/(σmax·N_band))
    # exact dynamic per-age expansion: age = 8·hi + lo → two bf16 matmuls
    age_onehot_hi: jnp.ndarray   # (N, 13) bf16
    age_onehot_lo: jnp.ndarray   # (N, 8) bf16
    iot: jnp.ndarray             # (V, 21)
    inf_mult: jnp.ndarray        # (V,)
    asymp_mult: jnp.ndarray      # (V,)
    mask_pw: jnp.ndarray         # (V,)
    mask_po: jnp.ndarray         # (V,)
    p_hosp_death_no_beds: jnp.ndarray  # (V,)
    p_icu_death_no_beds: jnp.ndarray   # (V,)
    mu_incub: jnp.ndarray        # (V,)
    mu_death: jnp.ndarray        # (V,)
    mu_recov: jnp.ndarray        # (V,)
    ratio_before_hosp: jnp.ndarray  # (V,)
    ratio_in_ward: jnp.ndarray   # (V,)
    # imported infections
    import_cum_p: jnp.ndarray    # (Cc,)
    import_min_age: jnp.ndarray  # (Cc,)
    import_max_age: jnp.ndarray  # (Cc,)
    # vaccination slots
    vacc_min_age: jnp.ndarray    # (S,)
    vacc_max_age: jnp.ndarray    # (S,)


class SchedRow(NamedTuple):
    """One day's slice of the compiled schedules."""
    mobility: jnp.ndarray        # (A, P)
    mobility_scalar: jnp.ndarray
    mask_p: jnp.ndarray          # (A, P)
    testing_mode: jnp.ndarray
    trace_p: jnp.ndarray
    detect_anyway_p: jnp.ndarray
    beds_build: jnp.ndarray
    icu_build: jnp.ndarray
    import_today: jnp.ndarray    # (V,)
    weekly_amount: jnp.ndarray
    weekly_shares: jnp.ndarray   # (V,)
    vacc_nr: jnp.ndarray         # (S,)


class DayOutputs(NamedTuple):
    by_group: jnp.ndarray        # (13, G) int32 — POP_ATTR x age-group counts
    available_hospital_beds: jnp.ndarray
    available_icu_units: jnp.ndarray
    total_icu_units: jnp.ndarray
    r: jnp.ndarray               # float32
    exposed_per_day: jnp.ndarray
    ct_cases_per_day: jnp.ndarray
    mobility_limitation: jnp.ndarray
    exposures_by_place: jnp.ndarray  # (P,) int32
    infected_by_variant: jnp.ndarray  # (V,) int32


# Order matters: the driver unpacks by position (see POP_ATTRS there).
GROUPED_ATTRS = (
    "susceptible", "vaccinated", "infected", "all_infected", "detected",
    "all_detected", "in_icu", "cum_icu", "in_ward", "dead", "recovered",
    "non_hospital_deaths", "new_infections",
)


def _round_to_int(f):
    """Reference round_to_int (main.pyx:773-774): floor(f + 0.5)."""
    return jnp.floor(f + 0.5).astype(jnp.int16)


def expand_by_age(arrays: ModelArrays, per_age, terms: int = 2):
    """Expand a dynamic (A,) table to per-agent values as bf16 one-hot
    matmuls (age = 8·hi + lo), the table split into ``terms`` bf16
    residual terms. Two terms preserve ~18 bits of relative precision
    (plenty for the float contact-count expansion); COUNT consumers
    need ``terms=3``: a cumulative count near 2^21 carries an error up
    to ~±16 with two terms, while three terms bound it below 2^-5 so
    rounding recovers the exact integer (see do_vaccination)."""
    A = per_age.shape[0]
    pad = arrays.age_onehot_hi.shape[1] * 8
    t2d = jnp.zeros(pad, per_age.dtype).at[:A].set(per_age).reshape(-1, 8)
    y = 0.0
    rem = t2d.astype(F32)
    for _ in range(terms):
        part = rem.astype(jnp.bfloat16)
        y = y + jnp.dot(arrays.age_onehot_hi, part,
                        preferred_element_type=F32)
        rem = rem - part.astype(F32)
    return jnp.sum(y * arrays.age_onehot_lo.astype(F32), axis=1)


def severity_from_uniform(val, syc_raw, dohc, sc, cc, fc, vmod):
    """The deterministic severity decision chain of
    get_symptom_severity (main.pyx:1041-1091) as a pure function of the
    uniform draw ``val`` and the (variant, age)-resolved probability
    terms — factored out so the hand-computed quantile fixture
    (tests/test_severity_fixture.py) can drive the EXACT code the
    engine runs at chosen ``val`` values. Includes the duplicated fatal
    branch quirk that sends every chain-fatal case to death outside
    hospital. Returns (severity i8, death_outside bool)."""
    asympt = val >= syc_raw
    syc = syc_raw * vmod
    fatal_doh = (dohc > 0) & (val < dohc * syc)
    val = jnp.where(dohc > 0, (val - dohc) / (1 - dohc), val)
    sev = jnp.where(val < sc * syc, C.SEVERE, C.MILD)
    sev = jnp.where(val < cc * sc * syc, C.CRITICAL, sev)
    fatal_chain = val < fc * cc * sc * syc
    sev = jnp.where(fatal_chain, C.FATAL, sev)
    outside = fatal_chain  # reference quirk: chain-fatal ⇒ dies outside
    sev = jnp.where(fatal_doh, C.FATAL, sev)
    outside = outside | fatal_doh
    sev = jnp.where(asympt, C.ASYMPTOMATIC, sev)
    outside = outside & ~asympt
    return sev.astype(jnp.int8), outside


def vaccine_modifier(dov_i, day):
    """1 − efficacy once the vaccination is older than the delay
    (main.pyx:1050-1056)."""
    return jnp.where(
        (dov_i >= 0) & ((day - dov_i.astype(I32)) > C.VACCINE_DELAY_DAYS),
        1.0 - C.VACCINE_EFFICACY, 1.0)


def _severity_draw_slots(key, arrays: ModelArrays, v_i, age_i, dov_i, day):
    """get_symptom_severity (main.pyx:1041-1091) on the compact
    infection-slot domain — severity only exists for agents infected
    today, so the draw runs on slot-sized vectors (small-table gathers
    by (variant, age)) instead of full-N passes. Returns
    (severity i8, death_outside bool)."""
    val = jr.uniform(key, v_i.shape, F32)
    return severity_from_uniform(
        val, arrays.p_sympt[v_i, age_i], arrays.p_doh[v_i, age_i],
        arrays.p_severe_c[v_i, age_i], arrays.p_critical_c[v_i, age_i],
        arrays.p_fatal_c[v_i, age_i], vaccine_modifier(dov_i, day))


def _binomial_split(key, totals, probs):
    """Per-category dart counts across the trailing axis of ``probs``:
    independent Binomial(totals, p_b) draws, vectorized as ONE
    while-free sampler call (ops/random.py). totals: (...,) float;
    probs: (..., B) with sum ≤ 1 (remainder = discard category).
    Returns (..., B) float32.

    Each draw is the EXACT marginal of the underlying multinomial; what
    is dropped is the (negative) cross-category covariance of the
    counts — a sequential conditional-binomial chain would sample the
    joint exactly but serialize B sampler invocations under
    ``lax.scan``. The covariance affects no per-category mean or
    variance, only the joint fluctuation of dart totals across bands (relative effect
    O(1/sqrt(K)) on the already-noisy total), and is documented in
    docs/parity.md (every consumer — dart splits and the
    exposures-by-place diagnostic — accepts the marginal split).

    The ~54 elementwise sampler rounds run on the FLATTENED domain
    rather than the 5-D (A, V, T, S, B) group arrays. Flattening is
    bit-exact: threefry bits are generated in row-major element order,
    so the same key over the same element count yields identical
    draws."""
    n_full = jnp.broadcast_to(totals[..., None].astype(F32), probs.shape)
    flat = binomial_fixed(key, n_full.reshape(-1),
                          probs.astype(F32).reshape(-1))
    return flat.reshape(probs.shape)


def dart_success(q_hat, save, sigma_max):
    """Candidate-dart success per (variant, source age, target band):
    place-marginalized contact probability × (1 − mask save) × band
    σmax. q_hat: (A, P, B); save: (V, A, P); sigma_max: (V, B).
    HIGHEST precision: on GPUs a float32 contraction may otherwise run
    in TF32, which keeps about three decimal digits."""
    return jnp.einsum("apb,vap->vab", q_hat, 1.0 - save,
                      precision=jax.lax.Precision.HIGHEST
                      ) * sigma_max[:, None, :]


def _group_counts(cfg: EngineConfig, arrays: ModelArrays, masks):
    """Count agents per output age group for each mask as one one-hot
    dot (ops/histogram.py). Exact: 0/1 values and f32 accumulation
    (counts < 2^24). Padding/excluded agents carry group code G and
    land in the dropped last column."""
    counts = onehot_counts(list(masks), arrays.group_of_agent,
                           cfg.nr_groups + 1)
    return counts[:, :-1].astype(I32)


def _tab(table, idx, v_count):
    """Select table[idx] per agent from a (V,) table via unrolled
    variant selects."""
    acc = jnp.full(idx.shape, table[0], table.dtype)
    for v in range(1, v_count):
        acc = jnp.where(idx == v, table[v], acc)
    return acc


def _phase4_prologue(st8, dl, doil, doi, sev8, var8, wdet, isinf, act,
                     z, nc_ag, incl, ninf, iot2, asym, infm, day):
    """Exposure-phase per-agent prep: infectiousness-over-time lookup,
    exposer gating, lognormal contact counts (main.pyx:895-953,
    1306-1320) — plus the R_t bookkeeping element passes (newly-removed
    mask, included update, masked infection counts; main.pyx:1968-1972),
    which read the same start-of-day state streams (their sums stay
    outside). Pure elementwise: the iot lookup is an unrolled
    (variant, day) select over the small (V, T) table."""
    st = st8.astype(I32)
    sev = sev8.astype(I32)
    var = var8.astype(I32)
    V, T = iot2.shape

    removed = (st == C.RECOVERED) | (st == C.DEAD)
    count_now = removed & ~incl & act
    included = incl | count_now
    ninf_m = jnp.where(count_now, ninf, 0)

    day_rel = jnp.where(st == C.INCUBATION, -dl.astype(I32),
                        doil.astype(I32))
    iot_idx = day_rel + C.IOT_OFFSET
    iot_ok = (iot_idx >= 0) & (iot_idx < T)
    iot_idx_c = jnp.clip(iot_idx, 0, T - 1)
    can_expose = (((st == C.INCUBATION) & (doi.astype(I32) < day))
                  | (st == C.ILLNESS))
    asympt = sev == C.ASYMPTOMATIC

    iot_val = jnp.zeros(st.shape, F32)
    for v in range(V):
        for t in range(T):
            iot_val = jnp.where((var == v) & (iot_idx_c == t),
                                iot2[v, t], iot_val)
    inf_base = (iot_val
                * jnp.where(asympt, _tab(asym, var, V), 1.0)
                * _tab(infm, var, V))
    exposer = can_expose & iot_ok & act & ~wdet & isinf
    inf_base = jnp.where(exposer, inf_base, 0.0)
    exposer = inf_base > 0

    sympt_ill = (st == C.ILLNESS) & ~asympt
    factor = jnp.where(sympt_ill, C.SYMPTOMATIC_CONTACT_FACTOR, 1.0)
    limit = jnp.where(sympt_ill, C.SYMPTOMATIC_CONTACT_LIMIT,
                      C.DEFAULT_CONTACT_LIMIT)
    f = jnp.exp(C.CONTACT_LOGNORMAL_SIGMA * z) * nc_ag * factor
    f = jnp.maximum(f, 1.0)
    k_s = jnp.clip(jnp.floor(f).astype(I32) - 1, 0, limit)
    k_s = jnp.where(exposer, k_s, 0)

    vts = (var * T + iot_idx_c) * 2 + asympt.astype(I32)
    return exposer, inf_base, k_s, vts, count_now, included, ninf_m


def _finalize_body(st, sevv, var, var_new, dl, doil, doi, newly, isinf,
                   trc, det, det_hosp, day, ct):
    """End-of-day merge of today's new infections into the carried
    agent fields plus the narrow output casts (person_infect writes,
    main.pyx:209-235). 16-bit streams compute in i32 and cast at the
    stores."""
    st_n = jnp.where(newly, C.INCUBATION, st)
    var_n = jnp.where(newly, var_new, var)
    doi_n = jnp.where(newly, day, doi.astype(I32))
    doil_n = jnp.where(newly, 0, doil.astype(I32))
    return (st_n.astype(jnp.int8), sevv.astype(jnp.int8),
            var_n.astype(jnp.int8), dl.astype(jnp.int16),
            doil_n.astype(jnp.int16), doi_n.astype(jnp.int16),
            isinf | newly,
            # a new infectee mallocs its own infectee list iff tracing
            # is active at its infection time (main.pyx:227-233)
            trc | (newly & ct),
            det | det_hosp)


def _make_receiver_body(v_count, n_bands):
    """Exposure receiver side: per-band dart totals → per-agent hit
    intensity, infection draw and variant pick."""
    def body(band, *rest):
        lams = rest[:v_count]
        isinf, hasimm, act, u_inf, u_var = rest[v_count:v_count + 5]
        D2 = rest[v_count + 5]
        hs = []
        for v in range(v_count):
            d_ag = jnp.zeros(band.shape, F32)
            for b in range(n_bands):
                d_ag = jnp.where(band == b, D2[v, b], d_ag)
            # 1 − (1 − λ)^D = −expm1(D · log1p(−λ))
            hs.append(-jnp.expm1(d_ag * lams[v]))
        one_minus = 1.0
        h_sum = 0.0
        for h_v in hs:
            one_minus = one_minus * (1.0 - h_v)
            h_sum = h_sum + h_v
        p_inf = 1.0 - one_minus
        susceptible = act & ~isinf & ~hasimm
        new_contact = susceptible & (u_inf < p_inf)
        u = u_var * jnp.maximum(h_sum, 1e-30)
        run = jnp.zeros(band.shape, F32)
        nv = jnp.zeros(band.shape, I32)
        for h_v in hs[:-1]:
            run = run + h_v
            nv = nv + (u >= run).astype(I32)
        nv = jnp.clip(nv, 0, v_count - 1)
        return new_contact, nv, susceptible
    return body


def _make_recv_front_body(v_count, n_bands):
    """Exposure receiver + progression front half as one elementwise
    function: both are pure elementwise over the agent axis with no
    data dependency between them, and they share several input streams
    (state, severity, is_infected, active)."""
    recv = _make_receiver_body(v_count, n_bands)

    def body(band, *rest):
        lams = rest[:v_count]
        (isinf, hasimm, act, u_inf, u_var,
         st8, doi, dl, o2r, sev8, wdet, dout, doil, u_day,
         var8) = rest[v_count:v_count + 15]
        D2, rbt, rwt, scal_i, dap = rest[v_count + 15:]
        nc, nv, susc = recv(band, *lams, isinf, hasimm, act,
                            u_inf, u_var, D2)
        front = _phase5_front(st8, doi, isinf, act, dl, o2r, sev8, wdet,
                              dout, doil, u_day, var8, rbt, rwt, scal_i,
                              dap)
        return (nc, nv, susc) + front
    return body


def _phase5_front(st8, doi, isinf, act, dl, o2r, sev8, wdet, dout, doil,
                  u, var8, rbt, rwt, scal_i, dap):
    """Progression pre-ledger: advance counters, fire transitions,
    symptom-onset testing seeks and capacity requests
    (person_advance/person_become_ill, main.pyx:284-440). Pure
    elementwise; 16-bit fields compute in i32 and cast back at the
    stores."""
    st = st8.astype(I32)
    sev = sev8.astype(I32)
    var = var8.astype(I32)
    dl = dl.astype(I32)
    doil = doil.astype(I32)
    V = rbt.shape[0]
    day = scal_i[0]
    mode = scal_i[1]

    adv_inc = (st == C.INCUBATION) & (doi.astype(I32) < day) & isinf & act
    adv_ill = (st == C.ILLNESS) & isinf & act
    adv_hosp = (st == C.HOSPITALIZED) & isinf & act
    adv_icu = (st == C.IN_ICU) & isinf & act
    adv_any = adv_inc | adv_ill | adv_hosp | adv_icu
    dl_new = jnp.where(adv_any, jnp.maximum(dl - 1, 0), dl)
    fire = adv_any & (dl_new == 0)

    rb = _tab(rbt, var, V)
    onset = adv_inc & fire
    illness_days = _round_to_int(
        o2r * jnp.where(sev >= C.SEVERE, rb, 1.0)).astype(I32)
    dl_a = jnp.where(onset, illness_days, dl_new).astype(jnp.int16)

    asympt = sev == C.ASYMPTOMATIC
    seek = onset & ~asympt & ~wdet
    queue_new = seek & (
        (mode == C.TESTING_ALL_WITH_SYMPTOMS)
        | (mode == C.TESTING_ALL_WITH_SYMPTOMS_CT)
        | ((mode == C.TESTING_ONLY_SEVERE_SYMPTOMS)
           & ((sev >= C.SEVERE) | (u < dap))))

    ill_end = adv_ill & fire
    die_home = ill_end & (sev == C.FATAL) & dout
    bed_request = ill_end & (sev >= C.SEVERE) & ~die_home
    recover_ill = ill_end & ~die_home & ~bed_request
    doil_new = jnp.where(adv_ill, doil + 1, doil).astype(jnp.int16)
    # (doil already widened to i32 above)

    hosp_end = adv_hosp & fire
    icu_request = hosp_end & (sev >= C.CRITICAL)
    hosp_recover = hosp_end & ~icu_request

    icu_end = adv_icu & fire
    icu_die = icu_end & (sev == C.FATAL)
    icu_recover = icu_end & ~icu_die

    return (dl_a, doil_new, onset, queue_new, die_home, bed_request,
            recover_ill, hosp_end, icu_request, hosp_recover, icu_end,
            icu_die, icu_recover)


def _phase5_post(st8, sev8, var8, o2r, dl_a, gbed, gicu, u, bed_request,
                 icu_request, die_home, recover_ill, hosp_recover,
                 icu_die, icu_recover, wdet, isinf, hasimm, evericu,
                 onset, rbt, rwt, picut, phospt):
    """Progression post-ledger: apply bed/ICU grants, denied-care death
    draws, hospitalization detection and the final state transition
    (person_hospitalize/transfer_to_icu/release, main.pyx:321-370).
    The same ``u`` serves the bed- and ICU-denial draws: an agent ends
    illness OR ends a ward stay on a given day, never both, so the
    uses are disjoint per agent-day. Pure elementwise."""
    st = st8.astype(I32)
    sev = sev8.astype(I32)
    var = var8.astype(I32)
    dl_a = dl_a.astype(I32)
    V = rbt.shape[0]
    rb = _tab(rbt, var, V)
    rw = _tab(rwt, var, V)

    bed_denied = bed_request & ~gbed
    die_chance = jnp.where(
        sev == C.FATAL, 1.0,
        jnp.where(sev == C.CRITICAL, _tab(picut, var, V),
                  _tab(phospt, var, V)))
    denied_die = bed_denied & (u < die_chance)
    denied_recover = bed_denied & ~denied_die
    hospitalized_now = bed_request & gbed
    hosp_days = _round_to_int(
        o2r * jnp.where(sev == C.SEVERE, 1.0 - rb, rw)).astype(I32)

    icu_denied = icu_request & ~gicu
    icu_die_chance = jnp.where(sev == C.FATAL, 1.0, _tab(picut, var, V))
    icu_denied_die = icu_denied & (u < icu_die_chance)
    # ICU-denied survivors still enter IN_ICU without claiming a unit —
    # faithful to person_transfer_to_icu (main.pyx:341-351)
    icu_enter = (icu_request & gicu) | (icu_denied & ~icu_denied_die)
    icu_days = _round_to_int(o2r * (1.0 - rw - rb)).astype(I32)

    detect_hosp = bed_request & ~wdet
    wdet_out = wdet | bed_request

    dies = die_home | denied_die | icu_denied_die | icu_die
    recovers = (recover_ill | denied_recover | hosp_recover
                | icu_recover)

    new_st = st
    new_st = jnp.where(onset, C.ILLNESS, new_st)
    new_st = jnp.where(hospitalized_now, C.HOSPITALIZED, new_st)
    new_st = jnp.where(icu_enter, C.IN_ICU, new_st)
    new_st = jnp.where(recovers, C.RECOVERED, new_st)
    new_st = jnp.where(dies, C.DEAD, new_st)

    days_left = dl_a
    days_left = jnp.where(hospitalized_now, hosp_days, days_left)
    days_left = jnp.where(icu_enter, icu_days, days_left)

    isinf_out = isinf & ~(dies | recovers)
    hasimm_out = hasimm | ((dies | recovers) & isinf)
    evericu_out = evericu | icu_enter

    return (new_st.astype(jnp.int8), days_left.astype(jnp.int16),
            isinf_out, hasimm_out, evericu_out, wdet_out, detect_hosp)


# Row index of each population attribute in DayOutputs.by_group —
# the single source of truth for every consumer (simulation driver,
# calibration scoring, tests). Must match the masks list in phase 7.
GROUP_ROW = {
    "susceptible": 0, "vaccinated": 1, "infected": 2, "all_infected": 3,
    "detected": 4, "all_detected": 5, "in_icu": 6, "cum_icu": 7,
    "in_ward": 8, "dead": 9, "recovered": 10, "non_hospital_deaths": 11,
    "new_infections": 12,
}


def _output_masks_reduced(active, is_inf, has_imm, dov, det, st, ever_icu,
                          dout, newly):
    """The 10 GROUP_ROW masks that genuinely need the agent axis. The
    other 3 are exact per-group identities (integer counts < 2^24):
      susceptible = active_per_group − all_infected   (active is static)
      infected    = all_infected − dead − recovered   (is_infected and
                    has_immunity are exclusive; has_immunity ⇔ DEAD or
                    RECOVERED — the same identity test_conservation
                    asserts)
      all_detected = detected + carried cumulative
    Dropping them cuts the phase-7 one-hot dot's lhs from 13 rows to
    10."""
    st = st.astype(jnp.int32)
    dov = dov.astype(jnp.int32)
    ever = is_inf | has_imm
    dead = st == C.DEAD
    return [
        active & (dov >= 0),                  # vaccinated
        active & ever,                        # all_infected
        active & det,                         # detected (today)
        active & (st == C.IN_ICU),            # in_icu
        active & ever_icu,                    # cum_icu
        active & (st == C.HOSPITALIZED),      # in_ward
        active & dead,                        # dead
        active & (st == C.RECOVERED),         # recovered
        active & dead & dout,                 # non_hospital_deaths
        active & newly,                       # new_infections
    ]


def tier_bounds(head: int, cap: int):
    """Geometric buffer tiers (head, 3·head, …): the single source of
    truth for tier sizes — shared by the tier loops AND the per-day
    key schedule so the part numbering can never drift."""
    head = min(head, cap)
    out = [(0, head)]
    lo = head
    while lo < cap:
        seg = min(lo * 3, cap) - lo
        out.append((lo, seg))
        lo += seg
    return out


class DayKeys(NamedTuple):
    """All RNG key material one day consumes, pre-derived.

    Batching every derivation over (chunk_days × parts) turns ~25
    scalar threefry ops per day into ~10 vectorized ops per CHUNK.
    Entries are bit-identical to the fold_in chains they replace
    (threefry is deterministic and element-independent under vmap)."""
    base: jnp.ndarray       # (17, 2) split(fold_in(base_key, day), 17)
    l1: jnp.ndarray         # (P1, 2) fold_in(k1, part)
    e1: jnp.ndarray         # (PE, 2) fold_in(k_e1, part)
    e2: jnp.ndarray         # (PE, 2) fold_in(k_e2, part)
    k_mem: jnp.ndarray      # (2,)
    vacc: jnp.ndarray       # (S, 2) fold_in(k_offset, 1000 + s)
    attr_age: jnp.ndarray   # (PK, 2) fold_in(k_attr_age, part)
    attr_src: jnp.ndarray   # (PK, 2)
    gam1: jnp.ndarray       # (PK, 2)
    gam2: jnp.ndarray       # (PK, 2)
    sev: jnp.ndarray        # (PK, 2)


def derive_day_keys(cfg: EngineConfig, base_key, day) -> DayKeys:
    """The exact key-derivation chains day_step used to run inline,
    as batched ops (vmap-able over a chunk of days)."""
    ks = jr.split(jr.fold_in(base_key, day), 17)
    k1, k_mem, k_e1, k_e2 = jr.split(ks[11], 4)
    k_offset = ks[14]
    p1 = len(tier_bounds(min(cfg.infection_head, cfg.infection_buffer),
                         cfg.infection_buffer))
    # bucket passes draw per (member tier × bucket-column tier)
    nb = len(tier_bounds(min(cfg.bucket_head, cfg.max_infectees),
                         cfg.max_infectees))
    pe = p1 * nb
    pk = len(tier_bounds(min(cfg.infection_head, cfg.infection_buffer),
                         cfg.infection_buffer))

    def tab(k, parts):
        return jax.vmap(lambda p: jr.fold_in(k, p))(parts)

    return DayKeys(
        base=ks,
        l1=tab(k1, jnp.arange(p1)),
        e1=tab(k_e1, jnp.arange(pe)),
        e2=tab(k_e2, jnp.arange(pe)),
        k_mem=k_mem,
        vacc=tab(k_offset, 1000 + jnp.arange(max(cfg.vacc_slots, 1))),
        attr_age=tab(ks[8], jnp.arange(pk)),
        attr_src=tab(ks[9], jnp.arange(pk)),
        gam1=tab(ks[6], jnp.arange(pk)),
        gam2=tab(ks[7], jnp.arange(pk)),
        sev=tab(ks[5], jnp.arange(pk)),
    )


def day_step(cfg: EngineConfig, arrays: ModelArrays, sched: SchedRow,
             state: AgentState, carry: DayCarry, base_key,
             day_keys: DayKeys | None = None):
    """Advance one day. Returns (state, carry, DayOutputs)."""
    N = state.age.shape[0]
    A = arrays.age_start.shape[0] - 1
    V = cfg.nr_variants
    P = C.NR_PLACES
    B = arrays.band_counts.shape[0]

    day = carry.day
    if day_keys is None:
        day_keys = derive_day_keys(cfg, base_key, day)
    dk = day_keys
    # NOTE: 17-way split with three reserved slots (_r*): they carried
    # the removed sequential trace / no-care-death streams; dropping
    # them would re-key every stream and shift all trajectories for no
    # semantic reason.
    (k_contact, k_bin, k_place, k_inf, k_var, _k_sev, _k_gam1, _k_gam2,
     _k_attr_age, _k_attr_src, k_imp, _k_trace1, _r1, k_anyway,
     k_offset, _r2, _r3) = dk.base

    age = state.age.astype(I32)
    variant = state.variant.astype(I32)
    sev = state.severity.astype(I32)
    st = state.state.astype(I32)
    active = state.active
    problem = carry.problem

    # ---- phase 1: capacity builds + weekly imports --------------------
    beds_total = carry.beds_total + sched.beds_build
    icu_total = carry.icu_total + sched.icu_build
    beds_avail = carry.beds_avail + sched.beds_build
    icu_avail = carry.icu_avail + sched.icu_build

    leftover = carry.weekly_leftover + sched.weekly_amount / 7.0 * sched.weekly_shares
    weekly_today = jnp.floor(leftover).astype(I32)
    leftover = leftover - weekly_today
    import_counts = sched.import_today + weekly_today  # (V,)

    # ---- phase 2: R_t totals over newly-removed agents ---------------
    # the element passes (newly-removed mask, included update, masked
    # counts) live in the phase-4 prologue — they read the same
    # start-of-day state streams; only the two sums live here (the
    # removal test uses start-of-day state either way)

    # ---- phase 3: testing drain, tracing, vaccination -----------------
    drained = state.queued
    ct_cases = jnp.sum(drained & active, dtype=I32)
    newly_detected = drained & ~state.was_detected
    was_detected = state.was_detected | drained
    detected_today = newly_detected
    queued = jnp.zeros_like(drained)

    ct_active = sched.testing_mode == C.TESTING_ALL_WITH_SYMPTOMS_CT
    is_dead = st == C.DEAD

    Tcap = cfg.infection_buffer  # compact traced-source buffer size
    CAPB = cfg.max_infectees
    bkt_fill = carry.bkt_fill
    # the bucket table stays FLAT (N·CAPB,) on device, so no flat<->2-D
    # reshape of the table is ever needed
    #
    # apply YESTERDAY's pending appends first: the scatter is then the
    # carried table's first (and only pre-write) use, so XLA updates it
    # in place. Scattering at phase 6 — after the tracing cond's
    # gathers — would force a full copy of the table every day (the
    # scheduler cannot prove the write-after-read safe through the
    # conditional). Tracing semantics are identical either way: phase-3
    # reads only ever saw appends from previous days.
    # tiered apply: pending entries are a prefix of the stream (the
    # append sort puts invalid slots last; mid-prefix overflow slots
    # are drop sentinels), so the head span applies unconditionally and
    # geometric tails ride conds on the pending count (p75 of daily
    # appends is ~1k of the 64k stream)
    _ah = min(cfg.infection_head, cfg.infection_buffer)
    bd_flat = carry.bkt_dst.at[carry.app_pos[:_ah]].set(
        carry.app_val[:_ah], mode="drop", unique_indices=True)
    _lo = _ah
    while _lo < cfg.infection_buffer:
        _hi = min(_lo * 3, cfg.infection_buffer)
        bd_flat = jax.lax.cond(
            carry.app_n > _lo,
            lambda b, _lo=_lo, _hi=_hi: b.at[carry.app_pos[_lo:_hi]].set(
                carry.app_val[_lo:_hi], mode="drop", unique_indices=True),
            lambda b: b, bd_flat)
        _lo = _hi
    bucket_tiers = tier_bounds(min(cfg.bucket_head, CAPB), CAPB)
    member_tiers = tier_bounds(min(cfg.infection_head, Tcap), Tcap)

    def do_tracing(queued):
        """2-level contact-tracing BFS (perform_contact_tracing,
        main.pyx:495-512) over per-source infectee BUCKETS — the
        vectorized twin of the reference's fixed-capacity per-person
        ``infectees`` arrays (main.pyx:128,209-233).

        A candidate is queued iff ANY of its edges succeeds a
        Bernoulli(trace_p) draw — per-edge draws are exactly the
        reference's first-edge-wins queueing (P = 1 − (1−p)^n).
        Infectee edges come from the bucket rows of queued sources
        (appended at infection when the SOURCE owned a list,
        main.pyx:218-223); removed sources never fire because the pass
        requires the source to still be infected — the reference frees
        lists on removal (main.pyx:301-307). Infector links come
        straight from the infector array (they survive the source's
        removal, like the reference's persistent ``infector`` field).

        The earlier formulation streamed an append-log edge TABLE:
        three full-table passes per tracing day, each touching every
        live edge regardless of the queue size. Bucket rows make
        each lookup queue-sized — (member tier × bucket-column tier)
        gathers gated by the members' actual fill counts — and remove
        the prune/compaction machinery entirely (buckets of removed
        sources are simply never read again).

        Level-2 recursion onto infectors is folded into level 1's
        passes via a per-MEMBER pre-folded table (r2_tab): a target t
        reached through several edges draws the same value — exactly
        one recursion attempt per queued member, as in the reference.
        Level-2 infectee edges read the buckets of the compacted
        level-1 frontier."""
        eligible = active & ~is_dead & ~was_detected & ~queued
        # per-member level-2 infector-attempt draws (same draw no matter
        # how many edges reached the member)
        u_mem = jr.uniform(dk.k_mem, (N,), F32)
        infector = state.infector
        # pre-fold the whole level-2 attempt into ONE per-agent table:
        # r2_tab[t] = t's infector if t would recurse when queued, else
        # the drop sentinel.
        r2_tab = jnp.where(eligible & (u_mem < sched.trace_p)
                           & (infector >= 0), infector, N)

        def recurse_targets(tgt, hit_ok):
            """Level-2 infector candidates for level-1 hits ``tgt``
            (buffer-sized): queued iff eligible, then Bernoulli via the
            member-keyed table, targeting their infector. hit_ok
            implies tgt < N (a fired edge has a real target), so the
            clip never changes a consulted value."""
            return jnp.where(hit_ok, r2_tab[jnp.clip(tgt, 0, N - 1)], N)

        # Tier execution: ONE lax.switch on the tier CEILING, each
        # branch processing members [0, sizes[k]) in a single block —
        # the earlier formulation chained cumulative tier bodies under
        # lax.cond, paying every active tier's full op set
        # (slice/gather/uniform/compare/2 scatters ≈ 15-20 ops) on
        # heavy days. Each branch draws ONE uniform block of its
        # merged shape from the pass's first tier key (assembling the
        # old per-tier key blocks would add ~7k threefry equations to
        # the jaxpr — a compile-time hazard); this RE-KEYS the tracing
        # draws vs round 4 (still i.i.d. uniform per (member, col) —
        # an equally-valid sample path, docs/parity.md re-keying note).
        # Sentinel members (used=False / live=False) never fire.
        mem_sizes = [lo + seg for lo, seg in member_tiers]
        sizes_arr = jnp.asarray(mem_sizes, I32)

        def bucket_passes(members_buf, src_ok, ktab, with_recurse,
                          hit, hit_r2, n_m):
            """Read the infectee buckets of compacted ``members_buf``
            in ONE (member-ceiling × column-ceiling) switch branch;
            scatter fired targets (and their folded level-2 infector
            candidates) into the shared hit buffers. ``src_ok`` (or
            None if members are prefiltered) gates per member;
            sentinel members read row N−1 harmlessly (their fill is
            forced to 0)."""
            def mem_branch(k):
                end = mem_sizes[k]

                def branch(carry):
                    hit, hit_r2 = carry
                    seg_buf = jax.lax.slice_in_dim(members_buf, 0, end)
                    used = seg_buf < N
                    bp = jnp.clip(seg_buf, 0, N - 1)
                    ok_m = used if src_ok is None else used & src_ok[bp]
                    fill_m = jnp.where(ok_m,
                                       jnp.minimum(bkt_fill[bp], CAPB), 0)
                    mf = jnp.max(fill_m)

                    def col_branch(c):
                        jend = bucket_tiers[c][0] + bucket_tiers[c][1]

                        def cb(carry):
                            hit, hit_r2 = carry
                            cols = jnp.arange(jend, dtype=I32)
                            idx = (bp[:, None] * CAPB
                                   + cols[None, :]).reshape(-1)
                            dst = bd_flat[idx].reshape(end, jend)
                            live = cols[None, :] < fill_m[:, None]
                            u = jr.uniform(ktab[0], (end, jend), F32)
                            fire = live & (u < sched.trace_p)
                            tgt = jnp.where(fire, dst, N).reshape(-1)
                            hit = hit.at[tgt].set(True, mode="drop")
                            if with_recurse:
                                t2 = jnp.where(
                                    fire, r2_tab[jnp.clip(dst, 0, N - 1)],
                                    N).reshape(-1)
                                hit_r2 = hit_r2.at[t2].set(True,
                                                           mode="drop")
                            return hit, hit_r2
                        return cb

                    col_ends = jnp.asarray(
                        [jlo + jseg for jlo, jseg in bucket_tiers], I32)
                    c_idx = jnp.searchsorted(col_ends, mf, side="left")
                    return jax.lax.switch(
                        c_idx, [col_branch(c)
                                for c in range(len(bucket_tiers))],
                        (hit, hit_r2))
                return branch

            k_idx = jnp.searchsorted(sizes_arr, jnp.minimum(n_m, Tcap),
                                     side="left")
            return jax.lax.switch(
                k_idx, [mem_branch(k) for k in range(len(mem_sizes))],
                (hit, hit_r2))

        # ---- level 1 (sources: the drained queue, compacted once) ----
        dbuf, n_d = compact_indices(drained & active, Tcap)

        def l1_branch(k):
            end = mem_sizes[k]

            def branch(carry):
                hit1, hit_r2a = carry
                seg_buf = jax.lax.slice_in_dim(dbuf, 0, end)
                used = seg_buf < N
                bp = jnp.clip(seg_buf, 0, N - 1)
                inf_s = infector[bp]
                u1 = jr.uniform(dk.l1[0], (end,), F32)
                succ = used & (inf_s >= 0) & (u1 < sched.trace_p)
                tgt = jnp.where(succ, inf_s, N)
                hit1 = hit1.at[tgt].set(True, mode="drop")
                t2a = recurse_targets(tgt, succ)
                hit_r2a = hit_r2a.at[t2a].set(True, mode="drop")
                return hit1, hit_r2a
            return branch

        # (N,)-sized with mode="drop" scatters (the N sentinel drops)
        hit1 = jnp.zeros(N, bool)
        hit_r2a = jnp.zeros(N, bool)
        k1_idx = jnp.searchsorted(sizes_arr, jnp.minimum(n_d, Tcap),
                                  side="left")
        hit1, hit_r2a = jax.lax.switch(
            k1_idx, [l1_branch(k) for k in range(len(mem_sizes))],
            (hit1, hit_r2a))
        # level-1 infectee buckets (+ inline level-2 infector
        # candidates), accumulating straight into l1's buffers
        hit12, hit_r2ab = bucket_passes(
            dbuf, state.is_infected, dk.e1, True, hit1, hit_r2a, n_d)

        newq1 = eligible & hit12

        # ---- level 2: infectee buckets of the compacted frontier ----
        # (infector attempts were folded in above); the fill>0 filter
        # keeps the compaction sized to members who own non-empty lists
        frontier = newq1 & state.is_infected & (bkt_fill > 0)
        fbuf, n_f = compact_indices(frontier, Tcap)
        hit2_l2, _ = bucket_passes(
            fbuf, None, dk.e2, False,
            jnp.zeros(N, bool), jnp.zeros(N, bool), n_f)
        return (queued | (eligible & (hit12 | hit_r2ab | hit2_l2)),
                (n_d > Tcap) | (n_f > Tcap))

    # the BFS only runs on days with contact tracing active and a
    # non-empty test queue — its scatter/gather ops are the step's most
    # expensive, so skip them entirely otherwise
    queued, trace_overflow = jax.lax.cond(
        ct_active & (ct_cases > 0), do_tracing,
        lambda q: (q, jnp.bool_(False)), queued)
    problem = jnp.where(trace_overflow,
                        problem | C.PROBLEM_TRACING_BUFFER_OVERFLOW,
                        problem)

    # Vaccination: oldest-first quota without permutation gathers —
    # per-age eligible counts via one matmul, whole cohorts older than
    # the boundary age vaccinate fully, the boundary age binomially at
    # the exact leftover fraction (within-age order is arbitrary in the
    # reference too, main.pyx:560-584; see docs/parity.md).
    # The whole block (one matmul + N-uniform + N-pass per slot) runs
    # under lax.cond: the default calendar has no
    # vaccinations before late 2020, and the per-slot uniforms are
    # fold_in-keyed (not a sequential stream), so skipping idle days is
    # bit-exact — on idle days nr=0 made every ``take`` False anyway.
    def do_vaccination(dov):
        for s in range(cfg.vacc_slots):
            nr = jnp.floor(sched.vacc_nr[s])
            mn, mx = arrays.vacc_min_age[s], arrays.vacc_max_age[s]
            eligible = (active & ~is_dead & ~was_detected & (dov < 0)
                        & (age >= mn) & (age <= mx))
            counts = onehot_counts([eligible], arrays.ages, A)[0]  # (A,)
            older = jnp.concatenate(
                [jnp.cumsum(counts[::-1])[:-1][::-1], jnp.zeros(1, F32)])
            # the whole oldest-first decision folds into ONE per-age
            # acceptance probability computed EXACTLY on the (A,)
            # domain (counts/older are exact f32 integers < 2^24):
            # 0 when the quota is exhausted, 1 for fully-covered
            # cohorts (u < 1.0 always holds for u ~ U[0,1)), the exact
            # leftover fraction at the boundary age. Only ONE 2-term
            # expansion of a [0,1] ratio per slot, replacing two
            # 3-term count expansions; the bf16 residual (~2^-16
            # relative) wobbles the boundary-age draw by ~1e-5 —
            # far below sampling noise (docs/parity.md).
            need_a = nr - older
            frac_eff = jnp.where(
                need_a <= 0, 0.0,
                jnp.where(counts <= need_a, 1.0,
                          jnp.clip(need_a / jnp.maximum(counts, 1.0),
                                   0.0, 1.0)))
            u_vac = jr.uniform(dk.vacc[s], (N,), F32)
            take = eligible & (u_vac < expand_by_age(arrays, frac_eff))
            dov = jnp.where(take, day.astype(jnp.int16), dov)
        return dov

    dov = jax.lax.cond(jnp.sum(sched.vacc_nr) >= 1.0, do_vaccination,
                       lambda d: d, state.day_of_vaccination)

    # ---- phase 4: exposure --------------------------------------------
    # contact tensor scaling (small (A, P, B) work stays XLA)
    q = arrays.contact_base * sched.mobility[:, :, None]        # (A, P, B)
    nc_a = jnp.sum(q, axis=(1, 2))                              # (A,)
    q_hat = q / jnp.maximum(nc_a, 1e-9)[:, None, None]
    z = jr.normal(k_contact, (N,), F32)
    # nc_ag is a pure function of mobility (contact_base is static), and
    # mobility only changes on intervention days — reuse the carried
    # expansion otherwise. Bit-identical: same inputs, same dots.
    nc_ag = jax.lax.cond(
        jnp.all(sched.mobility == carry.mob),
        lambda _: carry.nc_ag,
        lambda _: expand_by_age(arrays, nc_a), 0)
    # iot lookup + exposer gating + contact counts + the R_t element
    # passes (main.pyx:895-953, 1306-1320, 1968-1972)
    exposer, inf_base, k_s, vts, count_now, included, ninf_m = (
        _phase4_prologue(
            state.state, state.days_left, state.day_of_illness,
            state.day_of_infection, state.severity, state.variant,
            was_detected, state.is_infected, active, z, nc_ag,
            state.included_in_totals, state.n_infected,
            arrays.iot, arrays.asymp_mult, arrays.inf_mult, day))
    exposed_per_day = jnp.sum(k_s, dtype=I32)
    total_infectors = jnp.sum(count_now, dtype=I32)
    total_infections = jnp.sum(ninf_m, dtype=I32)
    r_value = jnp.where(
        total_infectors > 5,
        total_infections.astype(F32)
        / jnp.maximum(total_infectors, 1).astype(F32),
        0.0)

    # mask protection per (variant, age, place): p(either mask saves)
    # = a + b − ab with a = m·p_others, b = m·p_wearer (main.pyx:926-933)
    m = sched.mask_p                                             # (A, P)
    a_ = m[None] * arrays.mask_po[:, None, None]
    b_ = m[None] * arrays.mask_pw[:, None, None]
    save = a_ + b_ - a_ * b_                                     # (V, A, P)
    Tq = dart_success(q_hat, save, arrays.sigma_max)            # (V, A, B)

    # aggregate contact counts by (age, variant, iot-day, asympt) group;
    # binomial(k, p) sums over same-p sources, so per-group totals give
    # exact dart counts at a tiny fraction of per-agent sampling cost.
    # Exact: k ≤ 128 are integers, summed in f32 (ops/histogram.py).
    VTS = V * C.IOT_LEN * 2
    K_age = bihistogram(jnp.where(exposer, vts, -1), VTS,
                        k_s.astype(F32), arrays.ages, A)           # (VTS, A)
    K_g = K_age.T.reshape(A, V, C.IOT_LEN, 2)

    # per-group infectiousness: iot[v,t] · asymp_mult[v]^s · inf_mult[v],
    # broadcast over source age → (1, V, T, S)
    ig = (arrays.iot[None, :, :, None]
          * jnp.stack([jnp.ones(V), arrays.asymp_mult], axis=-1)[None, :, None, :]
          * arrays.inf_mult[None, :, None, None])
    # π[a,v,t,s,b] = ig[·,v,t,s] · Tq[v,a,b]
    pi = ig[:, :, :, :, None] * Tq.transpose(1, 0, 2)[:, :, None, None, :]

    darts = _binomial_split(k_bin, K_g, pi)                      # (A,V,T,S,B)
    D = jnp.sum(darts, axis=(0, 2, 3))                           # (V, B)

    # receiver side: each dart hits a uniform agent of its band and is
    # accepted with σ(age)/σmax — thinning makes the per-target hit
    # count Binomial(D, σ/(σmax·N_band)); infection = at least one hit.
    # D[v, band] expands per-agent with band selects; log1p(−λ) is a
    # static per-agent table.
    band_t = arrays.band_ag                                      # (N,)
    u_inf = jr.uniform(k_inf, (N,), F32)
    u_var = jr.uniform(k_var, (N,), F32)

    # ---- phase 5 (front half shares the receiver's pass) ---------------
    # the receiver pass and the progression front half are independent
    # elementwise passes over the same agent streams; the ONE uniform
    # array (u_day) serves the
    # onset-seek, bed-denial and ICU-denial draws (disjoint per
    # agent-day — an agent fires at most one of those transitions/day)
    o2r = state.o2r
    u_day = jr.uniform(k_anyway, (N,), F32)
    scal_i = jnp.stack([day, sched.testing_mode.astype(I32)])

    (new_contact, new_variant, susceptible,
     dl_a, day_of_illness, onset, queue_new, die_home, bed_request,
     recover_ill, hosp_end, icu_request, hosp_recover, icu_end,
     icu_die, icu_recover) = _make_recv_front_body(V, B)(
        band_t, *[arrays.lam_log1p_ag[v] for v in range(V)],
        state.is_infected, state.has_immunity, active, u_inf, u_var,
        state.state, state.day_of_infection, state.days_left, o2r,
        state.severity, was_detected, state.death_outside,
        state.day_of_illness, u_day, state.variant,
        D, arrays.ratio_before_hosp, arrays.ratio_in_ward, scal_i,
        sched.detect_anyway_p)
    queued = queued | queue_new

    offset = jr.randint(k_offset, (), 0, N)
    # both ledgers (beds, ICU) ride one call; the columns stay flat
    # (N,) streams end-to-end
    (granted_bed, granted_icu), after2 = clamped_counter_grants(
        [hosp_end.astype(I32), icu_end.astype(I32)],
        [bed_request, icu_request],
        jnp.stack([beds_avail, icu_avail]), offset)
    beds_after, icu_after = after2[0], after2[1]

    (new_st, days_left, is_infected, has_immunity, ever_icu,
     was_detected, detect_hosp) = _phase5_post(
        state.state, state.severity, state.variant, o2r, dl_a,
        granted_bed, granted_icu, u_day, bed_request, icu_request,
        die_home, recover_ill, hosp_recover, icu_die, icu_recover,
        was_detected, state.is_infected, state.has_immunity,
        state.ever_icu, onset,
        arrays.ratio_before_hosp, arrays.ratio_in_ward,
        arrays.p_icu_death_no_beds, arrays.p_hosp_death_no_beds)
    # detect_hosp merges into detected_today in the finalize pass
    new_st = new_st.astype(I32)

    # ---- phase 6: merge new infections ---------------------------------
    # imported infections (one-shot + weekly)
    M = cfg.import_buffer
    cum_imp = jnp.cumsum(import_counts)
    tot_imports = cum_imp[-1]
    problem = jnp.where(tot_imports > M,
                        problem | C.PROBLEM_IMPORT_BUFFER_OVERFLOW, problem)
    def do_imports(_):
        slot_ids = jnp.arange(M, dtype=I32)
        slot_valid = slot_ids < tot_imports
        slot_variant = searchsorted_fixed(cum_imp, slot_ids, side="right")
        slot_variant = jnp.clip(slot_variant, 0, V - 1)

        u_imp = jr.uniform(k_imp, (M, cfg.import_attempts, 2), F32)
        cls = searchsorted_fixed(arrays.import_cum_p, u_imp[..., 0],
                                 side="left")
        cls = jnp.clip(cls, 0, arrays.import_cum_p.shape[0] - 1)
        lo = arrays.age_start[arrays.import_min_age[cls]]
        hi = arrays.age_start[jnp.minimum(arrays.import_max_age[cls] + 1, A)]
        pos = lo + jnp.floor(
            u_imp[..., 1] * jnp.maximum(hi - lo, 1).astype(F32)).astype(I32)
        cand = jnp.clip(pos, 0, N - 1)     # age-sorted layout: pos = agent id
        # one combined status gather: susceptible ⇔ SUSCEPTIBLE state
        cand_ok = susceptible[cand] & (hi > lo)
        first = jnp.argmax(cand_ok, axis=1)
        any_ok = jnp.any(cand_ok, axis=1)
        import_agent = cand[jnp.arange(M), first]
        import_ok = slot_valid & any_ok
        return jnp.where(import_ok, import_agent, N), slot_variant

    # import days are sparse — skip the pick machinery otherwise. The
    # cond returns (M,)-sized targets/variants, NOT an (N,)-sized pack:
    # an N-sized cond output is materialized even on the skip branch,
    # and the three M=512-stream scatters replace three full-N merge
    # passes.
    import_tgt, imp_var = jax.lax.cond(
        tot_imports > 0, do_imports,
        lambda _: (jnp.full(M, N, I32), jnp.zeros(M, I32)), 0)

    # merge semantics (reference order): an agent picked by an import
    # loses any same-day contact infection — import variant wins
    newly = new_contact.at[import_tgt].set(True, mode="drop")
    variant_new = new_variant.at[import_tgt].set(imp_var, mode="drop")
    new_contact = new_contact.at[import_tgt].set(False, mode="drop")

    # ONE compact buffer over all of today's new infections (contacts +
    # imports): attribution runs on the contact slots, per-infection
    # gamma draws on every slot — Kcap ≪ N, so the duration sampling
    # costs a fraction of full-N draws.
    #
    # The slot pipeline (bisect compaction, attribution bisects, gumbel
    # age draw, gamma draws) is gather-bound and scales with the slot
    # count, so it runs in tiers: a small head every day, and the large
    # tail only on days with > infection_head new infections.
    Kcap = cfg.infection_buffer
    Kh = min(cfg.infection_head, Kcap)
    # cum_newly is exact (integer-valued f32); cum_cat is a float sum
    # whose association follows XLA's cumsum (docs/parity.md
    # deviation 12)
    c_s = jnp.where(exposer, k_s.astype(F32) * inf_base, 0.0)
    cum_newly = jnp.cumsum(newly.astype(F32))
    # per-variant source weights as ONE concatenated (V*N,) cumulative
    # pass: variant v's segment lives at [v*N, (v+1)*N), so attribution
    # bisects ALL slots in one bracketed search instead of one bisect
    # per variant (the bracket [v*N + age_start, ...) selects both the
    # variant segment and the age cohort)
    cum_cat = concat_cumsum(c_s, variant, V)
    n_new = cum_newly[-1].astype(I32)
    problem = jnp.where(n_new > Kcap,
                        problem | C.PROBLEM_INFECTION_BUFFER_OVERFLOW, problem)

    def compact_part(lo_slot: int, n_slots: int):
        # cum_newly is exact-integer f32; compare against f32 queries.
        # Two-level bisect: the ≤104-entry level-1 subsample gathers as
        # selects (~free), cutting gathered rounds log2(N) → log2(block)
        slots = lo_slot + jnp.arange(n_slots, dtype=I32)
        buf = searchsorted_compact(cum_newly, (slots + 1).astype(F32),
                                   side="left")
        used = slots < jnp.minimum(n_new, Kcap)
        return jnp.where(used, buf, N)

    # the agent layout is age-sorted, so per-variant weights (segments
    # of the cumulative pass above) are already in age order — no
    # N-permutation gather needed
    C_av = jnp.sum(K_g * ig, axis=(2, 3))                        # (A, V)
    kappa_inc = 1.0 / (C.INCUBATION_CV ** 2)
    kappa_o2r = 1.0 / (C.ONSET_TO_REMOVED_CV ** 2)

    def slot_pipeline(buf_part, part: int):
        """Attribution, severity/duration draws and standard gammas for
        one buffer tier — everything a new infection needs, computed on
        slot-sized vectors (person_infect, main.pyx:209-235).
        Attribution is a two-stage categorical: source age class ∝
        C[a,v]·T[v,a,b], then source within class ∝ contacts ×
        infectiousness — exact under dart Poissonization."""
        m = buf_part.shape[0]
        used = buf_part < N
        bp = jnp.clip(buf_part, 0, N - 1)
        contact_p = new_contact[bp] & used
        age_i = age[bp]
        # band via the ≤101-entry static table instead of an N-array
        # gather
        b_i = arrays.band_of_age[age_i].astype(I32)
        v_i = variant_new[bp]
        w = C_av.T[v_i] * Tq.transpose(0, 2, 1)[v_i, b_i]        # (m, A)
        gumb = jr.gumbel(dk.attr_age[part], w.shape, F32)
        logw = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-30)), -jnp.inf)
        a_star = jnp.argmax(logw + gumb, axis=1).astype(I32)
        u_src = jr.uniform(dk.attr_src[part], (m,), F32)
        # the source lives inside the sampled (variant, age bucket)
        # segment of the concatenated cumulative weights: ONE bracketed
        # bisect serves every slot regardless of variant
        off = v_i * N
        lo_i = off + arrays.age_start[a_star]
        hi_i = off + arrays.age_start[a_star + 1]
        # ONE batched gather for both bracket endpoints
        both = cum_cat[jnp.concatenate([jnp.maximum(lo_i - 1, 0),
                                        jnp.maximum(hi_i - 1, 0)])]
        lo_c = jnp.where(lo_i > 0, both[:m], 0.0)
        hi_c = both[m:]
        x = lo_c + u_src * (hi_c - lo_c)
        pos = searchsorted_fixed(cum_cat, x, side="left",
                                 lo_init=lo_i, hi_init=hi_i,
                                 max_range=cfg.max_age_cohort)
        src = jnp.clip(pos - off, 0, N - 1)   # age-sorted: pos = agent id
        ok = (hi_c > lo_c) & contact_p
        inf_new = jnp.where(ok, src, -1)
        # does the source own an infectee list? (main.pyx:218-223: the
        # edge is recorded iff the list was malloc'ed when the SOURCE
        # was infected, not iff tracing is active today)
        tr_src = ok & state.traceable[src]
        g1 = gamma_fixed(dk.gam1[part], kappa_inc, (m,))
        g2 = gamma_fixed(dk.gam2[part], kappa_o2r, (m,))
        # severity + durations per slot: (variant, severity)-dependent
        # scales applied to the standard-gamma draws (age_i gathered at
        # the top of the pipeline)
        dov_i = dov[bp]
        sev_i, outside_i = _severity_draw_slots(
            dk.sev[part], arrays, v_i, age_i, dov_i, day)
        theta_inc = (C.INCUBATION_CV ** 2) * arrays.mu_incub[v_i]
        incub_i = _round_to_int(g1 * theta_inc)
        mu_o2r = jnp.where(sev_i == C.FATAL, arrays.mu_death[v_i],
                           arrays.mu_recov[v_i])
        o2r_i = g2 * (C.ONSET_TO_REMOVED_CV ** 2) * mu_o2r
        return inf_new, tr_src, sev_i, outside_i, incub_i, o2r_i

    # geometric tiers (head, 3·head, 9·head, …) as ONE lax.switch on
    # the tier CEILING: branch k runs compaction + the whole slot
    # pipeline over slots [0, ends[k]) in a single block and pads the
    # tail with the drop-identity values. The earlier cumulative
    # cond chain paid every active tier's full pipeline op set — incl.
    # ~15 bisection-gather rounds per tier for the compaction and
    # attribution searches. Draws use the part-0 keys at the branch's
    # merged shape —
    # a RE-KEYING vs round 4 (i.i.d. uniforms either way;
    # docs/parity.md re-keying note).
    slot_ends = [lo + seg for lo, seg in tier_bounds(Kh, Kcap)]

    def slot_branch(k):
        end = slot_ends[k]

        def branch(_):
            b = compact_part(0, end)
            vals = (b,) + slot_pipeline(b, 0)
            if end == Kcap:
                return vals
            pads = (jnp.full(Kcap - end, N, I32),
                    jnp.full(Kcap - end, -1, I32),
                    jnp.zeros(Kcap - end, bool),
                    jnp.zeros(Kcap - end, jnp.int8),
                    jnp.zeros(Kcap - end, bool),
                    jnp.zeros(Kcap - end, jnp.int16),
                    jnp.zeros(Kcap - end, F32))
            return tuple(jnp.concatenate([v, p])
                         for v, p in zip(vals, pads))
        return branch

    ts_idx = jnp.searchsorted(jnp.asarray(slot_ends, I32),
                              jnp.minimum(n_new, Kcap), side="left")
    (buf_agent, infector_new, tr_slot, sev_slot, outside_slot,
     incub_slot, o2r_slot) = jax.lax.switch(
        ts_idx, [slot_branch(k) for k in range(len(slot_ends))], 0)
    slot_used = buf_agent < N

    src_scatter = jnp.where(slot_used & (infector_new >= 0), infector_new, N)

    # initialize newly-infected fields (person_infect, main.pyx:209-235):
    # severity/duration values were drawn on the slot domain and scatter
    # straight into the agent arrays (every newly agent owns one slot)

    # append infectee edges into per-source buckets (person_infect,
    # main.pyx:209-233: the source's fixed-capacity infectee array
    # gains the infectee iff the SOURCE owns a list, i.e. contact
    # tracing was active when the source itself was infected — not iff
    # tracing is active today). Same-source slots within one day need
    # distinct bucket columns, so the day's appends are sorted by
    # source and ranked within runs; lax.switch picks the smallest
    # slot-tier prefix covering today's count so quiet days sort only
    # the head. Per-source overflow (rank past CAPB) drops the edge
    # and raises the reference's TOO_MANY_INFECTEES problem
    # (main.pyx:219-220).
    #
    # CRITICAL layout rule: the (N·CAPB,) bucket table must NEVER be a
    # cond/switch output — an XLA conditional materializes each
    # table-sized result (and defeats scan-carry aliasing), a full copy
    # of the table on every call. The branches therefore return
    # only slot-sized (pos, val, src) streams, padded with drop
    # sentinels, and the table is touched exclusively by in-place
    # tiered scatters below (joining the slot-domain scatter tiers).
    e_valid = slot_used & (infector_new >= 0) & tr_slot
    n_app = jnp.sum(e_valid, dtype=I32)
    SENT = jnp.int32(1 << 30)
    sort_src = jnp.where(e_valid, infector_new, SENT)
    NC = N * CAPB

    def append_branch(end):
        def branch(_):
            src_k = jax.lax.slice_in_dim(sort_src, 0, end)
            dst_k = jax.lax.slice_in_dim(buf_agent, 0, end)
            src_s, dst_s = jax.lax.sort([src_k, dst_k], num_keys=1)
            idx = jnp.arange(end, dtype=I32)
            is_first = jnp.concatenate(
                [jnp.ones(1, bool), src_s[1:] != src_s[:-1]])
            run_start = jax.lax.cummax(jnp.where(is_first, idx, 0))
            rank = idx - run_start
            valid = src_s < SENT
            sp = jnp.clip(src_s, 0, N - 1)
            j = bkt_fill[sp] + rank
            store = valid & (j < CAPB)
            # dropped entries get UNIQUE ascending sentinels (NC + slot)
            # instead of one shared NC: XLA's scatter lowering can then
            # take the unique_indices path (no dedup machinery)
            pos = jnp.where(store, sp * CAPB + jnp.minimum(j, CAPB - 1),
                            NC + idx)
            val = jnp.where(store, dst_s, N)
            srcp = jnp.where(valid, sp, N)
            overflow = jnp.any(valid & (j >= CAPB))

            def pad(x, fillv):
                return jnp.concatenate(
                    [x, jnp.full(Kcap - end, fillv, x.dtype)]) \
                    if end < Kcap else x
            pos = (jnp.concatenate([pos, NC + jnp.arange(end, Kcap, dtype=I32)])
                   if end < Kcap else pos)
            return pos, pad(val, N), pad(srcp, N), overflow
        return branch

    slot_tier_ends = slot_ends   # same ladder as the slot-pipeline switch
    t_idx = jnp.searchsorted(jnp.asarray(slot_tier_ends, I32),
                             jnp.minimum(n_new, Kcap), side="left")
    app_pos, app_val, app_src, app_ovf = jax.lax.cond(
        n_app > 0,
        lambda _: jax.lax.switch(
            t_idx, [append_branch(e) for e in slot_tier_ends], 0),
        lambda _: (NC + jnp.arange(Kcap, dtype=I32),
                   jnp.full(Kcap, N, I32),
                   jnp.full(Kcap, N, I32), jnp.bool_(False)), 0)
    problem = jnp.where(app_ovf,
                        problem | C.PROBLEM_TOO_MANY_INFECTEES, problem)

    # Slot-domain scatters in two tiers: the first ``Kh`` slots always,
    # the tails only when today's infection count exceeds the head
    # (used slots are a prefix of the slot buffer, and a scatter streams
    # its whole span, dropped sentinels included). The tails ride ONE
    # lax.cond per tier: a conditional whose output is an (N,)-sized
    # array pays for that output even on the identity branch, so one
    # cond carries all six arrays. Head/tail indices are disjoint agent
    # ids (sentinels drop), so the split is bit-exact.
    scatter_jobs = [
        (state.infector, buf_agent, infector_new, False),
        (state.n_infected, src_scatter, jnp.ones_like(infector_new), True),
        (sev, buf_agent, sev_slot.astype(I32), False),
        (state.death_outside, buf_agent, outside_slot, False),
        (days_left, buf_agent, incub_slot, False),
        (o2r, buf_agent, o2r_slot, False),
    ]

    def _scatter_span(dst, idx, val, add, lo, hi):
        op = dst.at[idx[lo:hi]]
        return (op.add(val[lo:hi], mode="drop") if add
                else op.set(val[lo:hi], mode="drop"))

    scat = tuple(_scatter_span(d, i, v, a, 0, min(Kh, i.shape[0]))
                 for d, i, v, a in scatter_jobs)
    lo_t = Kh
    while lo_t < Kcap:
        hi_t = min(lo_t * 3, Kcap)

        def _tails(arrs, lo_t=lo_t, hi_t=hi_t):
            return tuple(_scatter_span(d, j[1], j[2], j[3], lo_t, hi_t)
                         for d, j in zip(arrs, scatter_jobs))

        # geometric tail tiers: a scatter streams its whole span
        # (dropped sentinels included), so one Kh->Kcap tail would
        # stream the full buffer on any day past the head while only
        # ~hi_t slots are live
        scat = jax.lax.cond(n_new > lo_t, _tails, lambda a: a, scat)
        lo_t = hi_t
    (infector, n_infected, sev_out, death_outside,
     days_left, o2r) = scat

    # bucket bookkeeping: the fill scatter lands today (readers of fill
    # and table only coincide AFTER next step's phase-0 apply, so fill
    # may lead the table by a day); the TABLE scatter is deferred into
    # the carry and applied at the top of the next step — see the
    # phase-0 comment. The fill stream is valid-first (sorted append
    # order puts SENT last), so the tail spans ride conds (a p75 of
    # ~1k live entries in a 64k stream).
    fill_ones = jnp.ones_like(app_src)
    bkt_fill = bkt_fill.at[app_src[:Kh]].add(fill_ones[:Kh], mode="drop")
    lo_f = Kh
    while lo_f < Kcap:
        hi_f = min(lo_f * 3, Kcap)
        bkt_fill = jax.lax.cond(
            n_app > lo_f,
            lambda f, lo_f=lo_f, hi_f=hi_f: f.at[app_src[lo_f:hi_f]].add(
                fill_ones[lo_f:hi_f], mode="drop"),
            lambda f: f, bkt_fill)
        lo_f = hi_f

    # ---- finalize: merge new infections into the carried fields ------
    # the elementwise merge/cast passes (new-state where-merges + the
    # int8/int16 output casts). A new infectee mallocs its OWN (empty)
    # infectee list iff contact tracing is active at its infection time
    # (main.pyx:227-233).
    (st8_out, sev8_out, var8_out, dl16_out, doil16_out, doi16_out,
     is_infected, traceable, detected_today) = _finalize_body(
        new_st, sev_out, variant, variant_new, days_left,
        day_of_illness, state.day_of_infection, newly, is_infected,
        state.traceable, detected_today, detect_hosp, day, ct_active)

    # ---- phase 7: outputs ----------------------------------------------
    # 10 GROUP_ROW masks from 9 raw end-of-day field streams, counted
    # per output age group in one one-hot dot; susceptible / infected /
    # all_detected are exact per-group derivations (see the mask fn)
    by10 = onehot_counts(
        _output_masks_reduced(active, is_infected, has_immunity, dov,
                              detected_today, st8_out, ever_icu,
                              death_outside, newly),
        arrays.group_of_agent, cfg.nr_groups + 1)[:, :-1].astype(I32)
    (vacc_g, ever_g, det_g, inicu_g, cicu_g, ward_g, dead_g, rec_g,
     nh_g, new_g) = by10
    all_detected = carry.all_detected + det_g
    # assemble the 13 GROUP_ROW rows (tiny (G,) ops)
    by_group = jnp.stack([
        arrays.active_per_group - ever_g,        # susceptible
        vacc_g,
        ever_g - dead_g - rec_g,                 # infected
        ever_g,                                  # all_infected
        det_g,
        all_detected,
        inicu_g, cicu_g, ward_g, dead_g, rec_g, nh_g, new_g])

    exposures = _exposures_by_place(k_place, K_g, q_hat)
    inf_by_variant = jnp.stack(
        [jnp.sum(newly & (variant_new == v), dtype=I32) for v in range(V)])

    out = DayOutputs(
        by_group=by_group,
        available_hospital_beds=beds_after,
        available_icu_units=icu_after,
        total_icu_units=icu_total,
        r=r_value,
        exposed_per_day=exposed_per_day,
        ct_cases_per_day=ct_cases,
        mobility_limitation=1.0 - sched.mobility_scalar,
        exposures_by_place=exposures,
        infected_by_variant=inf_by_variant,
    )

    new_state = AgentState(
        age=state.age,
        state=st8_out,
        severity=sev8_out,
        variant=var8_out,
        death_outside=death_outside,
        days_left=dl16_out,
        day_of_illness=doil16_out,
        day_of_infection=doi16_out,
        day_of_vaccination=dov,
        o2r=o2r,
        infector=infector,
        n_infected=n_infected,
        is_infected=is_infected,
        has_immunity=has_immunity,
        was_detected=was_detected,
        queued=queued,
        traceable=traceable,
        ever_icu=ever_icu,
        included_in_totals=included,
        active=active,
    )
    new_carry = DayCarry(
        day=day + 1,
        beds_avail=beds_after, icu_avail=icu_after,
        beds_total=beds_total, icu_total=icu_total,
        weekly_leftover=leftover,
        all_detected=all_detected,
        problem=problem,
        bkt_dst=bd_flat, bkt_fill=bkt_fill,
        mob=sched.mobility, nc_ag=nc_ag,
        app_pos=app_pos, app_val=app_val, app_n=n_app,
    )
    return new_state, new_carry, out


def _exposures_by_place(key, K_g, q_hat):
    """Sample the per-place split of all drawn contacts: the marginal
    place distribution per source age is multinomial (main.pyx:1571).

    Drawn as independent per-place binomials (ONE sampler call) rather
    than the sequential conditional-binomial chain: only the age-summed
    (P,) vector is emitted, each place total keeps its exact
    Binomial(K_a, q_ap) marginal, and what is dropped is the same
    negative cross-category covariance already documented for the dart
    split (docs/parity.md) — a sequential 8-call chain would serialize
    sampler invocations for a diagnostic curve."""
    K_age = jnp.sum(K_g, axis=(1, 2, 3))                          # (A,)
    qp = jnp.sum(q_hat, axis=2)                                   # (A, P)
    counts = _binomial_split(key, K_age, qp)                      # (A, P)
    return jnp.sum(counts, axis=0).astype(I32)


from ..utils.compile import engine_jit


@engine_jit(static_argnums=(0,))
def snapshot_outputs(cfg: EngineConfig, arrays: ModelArrays,
                     state: AgentState, carry: DayCarry,
                     mobility_scalar) -> DayOutputs:
    """Day-0 snapshot before any events (the reference emits state
    before the first iterate, calc/simulation.py:194-270).

    Jitted: run_days calls this once per run, and jit folds its ops
    into one cached program."""
    V = cfg.nr_variants
    st = state.state.astype(I32)
    active = state.active
    ever_infected = state.is_infected | state.has_immunity
    zero = active & False
    dead_m = st == C.DEAD
    masks = [
        active & ~ever_infected,
        active & (state.day_of_vaccination >= 0),
        active & state.is_infected,
        active & ever_infected,
        zero,
        zero,  # replaced by carry.all_detected below
        active & (st == C.IN_ICU),
        active & state.ever_icu,
        active & (st == C.HOSPITALIZED),
        active & dead_m,
        active & (st == C.RECOVERED),
        active & dead_m & state.death_outside,
        zero,
    ]
    by_group = _group_counts(cfg, arrays, masks).at[5].set(
        carry.all_detected)
    P = C.NR_PLACES
    return DayOutputs(
        by_group=by_group,
        available_hospital_beds=carry.beds_avail,
        available_icu_units=carry.icu_avail,
        total_icu_units=carry.icu_total,
        r=jnp.float32(0.0),
        exposed_per_day=jnp.int32(0),
        ct_cases_per_day=jnp.int32(0),
        mobility_limitation=1.0 - mobility_scalar,
        exposures_by_place=jnp.zeros(P, I32),
        infected_by_variant=jnp.zeros(V, I32),
    )
