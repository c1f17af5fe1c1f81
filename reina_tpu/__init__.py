"""REINA in JAX: an agent-based epidemic simulation framework.

A ground-up JAX/XLA rebuild of the REINA epidemic model
(kausaltech/reina-model). The population is a struct-of-arrays agent
state stepped by ``lax.scan`` over simulated days; per-agent contact
sampling, infection transmission, disease progression, healthcare
capacity, testing/contact-tracing and vaccination are all expressed as
vectorized XLA programs, with Monte-Carlo ensembles via ``vmap`` and
multi-chip scaling via ``jax.sharding`` meshes.

Layer map (mirrors the reference layer-for-layer):

  frontends   reina_tpu.runtime.graphql / reina_tpu.webui   (reference: corona.py, graphql_*)
  run orch.   reina_tpu.runtime                             (reference: simulation_thread.py)
  driver      reina_tpu.simulation                          (reference: calc/simulation.py)
  config      reina_tpu.config                              (reference: variables.py, common/interventions.py)
  data        reina_tpu.data                                (reference: calc/datasets.py, data/)
  core engine reina_tpu.core + reina_tpu.ops                (reference: cythonsim/)
"""

__version__ = "0.1.0"


def _enable_compilation_cache() -> None:
    """Persist compiled XLA programs across processes (a compile of the
    full day-step program takes minutes; repeat runs of the same shapes
    should not pay it again). Where the cache lives is decided by
    utils.compile.cache_dir_for_process; a failure to enable it is
    reported as a warning and the process runs uncached."""
    from .utils.compile import enable_persistent_cache

    try:
        enable_persistent_cache()
    except OSError as e:
        import warnings

        warnings.warn(f"persistent compilation cache not enabled: {e}")


_enable_compilation_cache()
