"""Model-parameter compilation: variables → dense device arrays.

The reference engine walks small C lookup tables per agent per draw
(``ClassifiedValues``/``cv_get_greatest_lte``, main.pyx:684-766) and
converts absolute severity probabilities to conditional ones at variant
init (main.pyx:820-850). We do all of that once, up front, producing
dense per-variant × per-age arrays the vectorized step can gather from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple

import numpy as np

from . import constants as C

# The engine's disease-parameter names (reference main.pyx:777-785).
DISEASE_PARAMS = (
    "p_susceptibility", "p_symptomatic", "p_severe", "p_critical",
    "p_fatal", "p_hospital_death_no_beds", "p_icu_death_no_beds",
    "p_death_outside_hospital", "p_asymptomatic_infection",
    "infectiousness_multiplier", "mean_incubation_duration",
    "mean_duration_from_onset_to_death", "mean_duration_from_onset_to_recovery",
    "ratio_of_duration_before_hospitalisation", "ratio_of_duration_in_ward",
    "p_mask_protects_wearer", "p_mask_protects_others", "variants",
)


def create_disease_params(variables: Dict[str, Any]) -> Dict[str, Any]:
    """%-style parameters → fractions (reference calc/simulation.py:50-61)."""
    out = {}
    for key in DISEASE_PARAMS:
        val = variables[key]
        if key.startswith("p_") or key.startswith("ratio_"):
            if isinstance(val, list):
                val = [(age, v / 100) for age, v in val]
            else:
                val = val / 100
        out[key] = val
    return out


def expand_greatest_lte(pairs: List, nr_ages: int) -> np.ndarray:
    """Dense per-age table using greatest-class-≤-age lookup
    (reference cv_get_greatest_lte, main.pyx:721-730: ages below the
    first class fall through to the *last* value — replicated)."""
    classes = [int(p[0]) for p in pairs]
    values = [float(p[1]) for p in pairs]
    out = np.empty(nr_ages, dtype=np.float32)
    for age in range(nr_ages):
        sel = values[-1]
        for k, v in zip(classes, values):
            if k <= age:
                sel = v
            else:
                break
        if age < classes[0]:
            sel = values[-1]
        out[age] = sel
    return out


def _cv_div(a: List, b: List) -> List:
    """Elementwise division of two (class, value) tables
    (absolute → conditional probability chaining, main.pyx:808-817)."""
    assert [x[0] for x in a] == [x[0] for x in b]
    return [(k1, v1 / v2) for (k1, v1), (_k2, v2) in zip(a, b)]


class DiseaseArrays(NamedTuple):
    """Per-variant dense tables; leading axis = variant (0 = wild type)."""
    p_susc: np.ndarray          # (V, A)
    p_sympt: np.ndarray         # (V, A)
    p_severe_c: np.ndarray      # (V, A) conditional on symptomatic
    p_critical_c: np.ndarray    # (V, A) conditional on severe
    p_fatal_c: np.ndarray       # (V, A) conditional on critical
    p_doh: np.ndarray           # (V, A) death-outside-hospital
    iot: np.ndarray             # (V, 21) infectiousness by day-from-onset
    inf_mult: np.ndarray        # (V,)
    asymp_mult: np.ndarray      # (V,)
    mask_pw: np.ndarray         # (V,) p(mask protects wearer)
    mask_po: np.ndarray         # (V,) p(mask protects others)
    p_hosp_death_no_beds: np.ndarray  # (V,)
    p_icu_death_no_beds: np.ndarray   # (V,)
    mu_incub: np.ndarray        # (V,)
    mu_death: np.ndarray        # (V,) onset → death
    mu_recov: np.ndarray        # (V,) onset → recovery
    ratio_before_hosp: np.ndarray  # (V,)
    ratio_in_ward: np.ndarray   # (V,)


def compile_disease(disease_params: Dict[str, Any], nr_ages: int,
                    ) -> tuple[DiseaseArrays, List[str]]:
    """Build per-variant arrays. Variant dicts override base params
    (reference Disease.__init__, main.pyx:868-881)."""
    variant_names = ["wild-type"]
    param_sets = [disease_params]
    for var in disease_params["variants"]:
        vp = dict(disease_params)
        vp.update(var)
        param_sets.append(vp)
        variant_names.append(var["name"])

    def age_tables(key, conditional_on=None):
        rows = []
        for ps in param_sets:
            pairs = ps[key]
            if conditional_on is not None:
                pairs = _cv_div(pairs, ps[conditional_on])
            rows.append(expand_greatest_lte(pairs, nr_ages))
        return np.stack(rows)

    def scalars(key):
        return np.array([float(ps[key]) for ps in param_sets], dtype=np.float32)

    iot = np.tile(np.array(C.INFECTIOUSNESS_OVER_TIME, dtype=np.float32),
                  (len(param_sets), 1))

    arrays = DiseaseArrays(
        p_susc=age_tables("p_susceptibility"),
        p_sympt=age_tables("p_symptomatic"),
        p_severe_c=age_tables("p_severe", "p_symptomatic"),
        p_critical_c=age_tables("p_critical", "p_severe"),
        p_fatal_c=age_tables("p_fatal", "p_critical"),
        p_doh=age_tables("p_death_outside_hospital"),
        iot=iot,
        inf_mult=scalars("infectiousness_multiplier"),
        asymp_mult=scalars("p_asymptomatic_infection"),
        mask_pw=scalars("p_mask_protects_wearer"),
        mask_po=scalars("p_mask_protects_others"),
        p_hosp_death_no_beds=scalars("p_hospital_death_no_beds"),
        p_icu_death_no_beds=scalars("p_icu_death_no_beds"),
        mu_incub=scalars("mean_incubation_duration"),
        mu_death=scalars("mean_duration_from_onset_to_death"),
        mu_recov=scalars("mean_duration_from_onset_to_recovery"),
        ratio_before_hosp=scalars("ratio_of_duration_before_hospitalisation"),
        ratio_in_ward=scalars("ratio_of_duration_in_ward"),
    )
    return arrays, variant_names


class PopulationArrays(NamedTuple):
    """Static population structure (agent axis padded to ``n_padded``)."""
    age_counts: np.ndarray     # (A,) int32 — active agents per age
    ages: np.ndarray           # (N,) uint8 — per-agent age (0 for padding)
    active: np.ndarray         # (N,) bool
    age_start: np.ndarray      # (A + 1,) int32 — layout is age-sorted, so
    #                            positions [age_start[a], age_start[a+1])
    #                            are the agents of age a (padding at tail)
    band_of_age: np.ndarray    # (A,) int32
    band_counts: np.ndarray    # (B,) int32 — agents per contact-age band
    group_of_agent: np.ndarray  # (N,) int32 — output age-group id (padding → G)
    nr_groups: int
    group_labels: List[str]


def make_age_groups(max_age: int) -> List[str]:
    """Reference calc/simulation.py:103-116: 10-year groups, 80+ capped."""
    out = []
    for age in range(max_age + 1):
        grp = age // 10
        out.append("80+" if grp >= 8 else f"{grp * 10}–{grp * 10 + 9}")
    return out


def compile_population(age_counts: np.ndarray, band_of_age: np.ndarray,
                       pad_multiple: int = 1024) -> PopulationArrays:
    age_counts = np.asarray(age_counts, dtype=np.int64)
    nr_ages = len(age_counts)
    n = int(age_counts.sum())
    n_padded = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple

    # Agents live at AGE-SORTED positions (padding at the tail): position
    # ranges double as the per-age index (age_start offsets address agents
    # directly), so uniform-in-age-band sampling and weighted infector
    # attribution need no N-sized permutation gather. The reference
    # instead shuffles the id
    # space (main.pyx:1434-1436) purely so its serial capacity sweep is
    # age-unbiased; our rationing uses a random cyclic offset whose
    # marginal grant probability is position-uniform either way — the
    # layout change is documented in docs/parity.md §deviations.
    ages = np.zeros(n_padded, dtype=np.uint8)
    ages[:n] = np.repeat(np.arange(nr_ages, dtype=np.uint8), age_counts)
    active = np.zeros(n_padded, dtype=bool)
    active[:n] = True

    age_start = np.zeros(nr_ages + 1, dtype=np.int32)
    age_start[1:] = np.cumsum(age_counts)

    nr_bands = int(band_of_age.max()) + 1
    band_counts = np.zeros(nr_bands, dtype=np.int32)
    np.add.at(band_counts, band_of_age, age_counts)

    labels = make_age_groups(nr_ages - 1)
    group_names = sorted(set(labels))
    group_idx = np.array([group_names.index(x) for x in labels], dtype=np.int32)
    group_of_agent = np.full(n_padded, len(group_names), dtype=np.int32)
    group_of_agent[:n] = group_idx[ages[:n]]

    return PopulationArrays(
        age_counts=age_counts.astype(np.int32),
        ages=ages, active=active, age_start=age_start,
        band_of_age=band_of_age.astype(np.int32),
        band_counts=band_counts,
        group_of_agent=group_of_agent,
        nr_groups=len(group_names),
        group_labels=group_names,
    )


@dataclass(frozen=True)
class ImportAges:
    """Imported-infection age distribution (reference main.pyx:1376-1384,
    1632-1650): weighted age classes → cumulative probabilities and the
    [min_age, max_age] range each class maps to."""
    cum_p: np.ndarray    # (Cc,) float32
    min_age: np.ndarray  # (Cc,) int32
    max_age: np.ndarray  # (Cc,) int32


def compile_import_ages(pairs: List, nr_ages: int) -> ImportAges:
    weight_sum = sum(w for _a, w in pairs) or 1.0
    cum, cum_p, mins, maxs = 0.0, [], [], []
    for i, (age, w) in enumerate(pairs):
        cum += w / weight_sum
        cum_p.append(cum)
        mins.append(int(age))
        maxs.append(int(pairs[i + 1][0]) - 1 if i + 1 < len(pairs) else nr_ages - 1)
    return ImportAges(
        cum_p=np.array(cum_p, dtype=np.float32),
        min_age=np.array(mins, dtype=np.int32),
        max_age=np.array(maxs, dtype=np.int32),
    )
