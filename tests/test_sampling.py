"""Parameter-distribution sampling API (reference main.pyx:2047-2101).

The distribution tests run in ONE fresh child interpreter
(test_sampling_isolated): their eager gamma/contact-scan compiles land
~100 compiles into a full-suite run, where the cumulative XLA:CPU
defect segfaults (tests/_isolation.py; reproduced twice at
test_incubation_period, in backend_compile_and_load and at a
persistent-cache read).
"""
import numpy as np
import pytest

from _isolation import ISOLATED, run_isolated

from reina_tpu.config.variables import VARIABLE_DEFAULTS
from reina_tpu.sampling import sample_distribution

needs_fresh_process = pytest.mark.skipif(
    not ISOLATED,
    reason="compile-fragile: executed inside test_sampling_isolated's "
           "child interpreter")


def test_sampling_isolated():
    """Run the guarded tests below in a fresh interpreter."""
    if ISOLATED:
        pytest.skip("already inside the isolated child")
    run_isolated("tests/test_sampling.py")


@pytest.fixture(scope="module")
def variables():
    return dict(VARIABLE_DEFAULTS)


@needs_fresh_process
def test_severity_distribution(variables):
    c = sample_distribution("symptom_severity", 80, None, variables)
    p = c / c.sum()
    # age 80: p_symptomatic = 0.90 → asymptomatic share ≈ 0.10
    assert abs(p.get("ASYMPTOMATIC", 0) - 0.10) < 0.02
    # fatal share ≈ dohc path + chain; with p_doh=0.5 dominant ≈ 0.45+
    assert p.get("FATAL", 0) > 0.3


@needs_fresh_process
def test_incubation_period(variables):
    c = sample_distribution("incubation_period", 30, None, variables)
    vals = np.repeat(c.index.to_numpy(), c.to_numpy())
    assert abs(vals.mean() - 5.1) < 0.3  # gamma mean 5.1
    assert abs(vals.std() / vals.mean() - 0.86) < 0.1


@needs_fresh_process
def test_contacts_per_day(variables):
    c = sample_distribution("contacts_per_day", 10, None, variables)
    vals = np.repeat(c.index.to_numpy(), c.to_numpy())
    assert 0 <= vals.min() and vals.max() <= 100
    assert vals.mean() > 5  # school-age children have many contacts


@needs_fresh_process
def test_periods_by_severity(variables):
    ill_mild = sample_distribution("illness_period", 30, "MILD", variables)
    ill_sev = sample_distribution("illness_period", 30, "SEVERE", variables)
    m_mild = np.repeat(ill_mild.index.to_numpy(), ill_mild.to_numpy()).mean()
    m_sev = np.repeat(ill_sev.index.to_numpy(), ill_sev.to_numpy()).mean()
    # severe cases spend only ratio_before_hosp (30%) of o2r in illness
    assert m_sev < m_mild
    np.testing.assert_allclose(m_mild, 21.0, rtol=0.1)
    np.testing.assert_allclose(m_sev, 21.0 * 0.3, rtol=0.15)

    icu = sample_distribution("icu_period", 30, "CRITICAL", variables)
    m_icu = np.repeat(icu.index.to_numpy(), icu.to_numpy()).mean()
    np.testing.assert_allclose(m_icu, 21.0 * (1 - 0.3 - 0.15), rtol=0.15)


@needs_fresh_process
def test_infectiousness_curve(variables):
    s = sample_distribution("infectiousness", 0, None, variables)
    assert s.idxmax() in (-1, 0)
    assert s.sum() > 0.99  # the published curve sums to ~1


def test_webui_served():
    from reina_tpu.webui import app_html
    html = app_html()
    assert b"<h1>REINA</h1>" in html and b"/graphql" in html


def test_webui_static_integrity():
    """Behavioral replacement for the old string asserts (no browser
    exists in this image — tools/check_webui.py): bracket balance of
    the inline JS, handler/ id reference closure, and presence of the
    interaction hooks. A mistyped handler name or dangling
    getElementById fails here."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from check_webui import check_static
    assert check_static() == []


def test_webui_documents_replay():
    """Every GraphQL document embedded in the web UI executes against
    the real schema engine (field drift between page JS and schema
    fails here). Documents that hit the engine's samplers are
    excluded — they belong to the isolated compile-heavy suites."""
    import os
    import re
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from check_webui import extract_documents

    from reina_tpu.config.variables import VariableStore
    from reina_tpu.runtime.graphql.engine import execute
    from reina_tpu.runtime.graphql.schema import SCHEMA

    sample_vars = {"id": "check-run", "d": 365, "v": 1.0, "a": 60,
                   "m": 0, "e": {"type": "limit-mobility",
                                 "date": "2020-05-01",
                                 "parameters": [{"id": "reduction",
                                                 "value": 10}]}}
    replayed = 0
    for doc in extract_documents():
        if "sampleDistribution" in doc or "runSimulation" in doc:
            continue   # engine-compiling paths, covered elsewhere
        wanted = set(re.findall(r"\$([A-Za-z_]\w*)", doc))
        variables = {k: v for k, v in sample_vars.items() if k in wanted}
        if "setParameter" in doc:
            variables["id"] = "p_asymptomatic_infection"
            variables["v"] = 50.0
        if "activateScenario" in doc:
            variables["id"] = "default"
        assert wanted <= set(variables), (wanted, doc[:80])
        out = execute(SCHEMA, doc, variables=variables,
                      context={"store": VariableStore()})
        acceptable = ("No simulation run active", "invalid intervention ID")
        for err in (out.get("errors") or []):
            assert any(a in err.get("message", "") for a in acceptable), \
                (err, doc[:100])
        replayed += 1
    assert replayed >= 12
