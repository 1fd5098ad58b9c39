"""The JAX package's suites over the port's knowledge, ingest-stage, helper,
native-result and data-model modules, run against the port.

``test_knowledge.py`` (``knowpro/knowledge.py``), ``test_pipeline_stages.py``
(``knowpro/add_messages.py``), ``test_small_modules.py`` (``convutils``,
``messageutils``, ``textlocindex``, threads), ``test_native_results.py``
(``native.load_results_module``) and ``test_interfaces_matrix.py``
(``knowpro/interfaces``, ``kplib``) are read from their source with their
imports pointed at ``typeagent_tpu_torch``, as ``test_torch_query_suites.py``
does, and each test is put into this module under ``test_<suite>__<test>``.
The tests the port cannot run are in :data:`EXCLUDED`, each with its reason.
"""

from test_torch_query_suites import check_mirrored, mirror

SUITES = (
    "test_knowledge.py",
    "test_pipeline_stages.py",
    "test_small_modules.py",
    "test_native_results.py",
    "test_interfaces_matrix.py",
)
EXCLUDED: dict = {}
# Two tests build embedding settings inside the test body, where the
# mirror's module-level ``device="cpu"`` does not reach: the port's settings
# default to the card, so they are given the CPU here.
REWRITE = {
    "test_knowledge.py": (
        ("TextEmbeddingIndexSettings(model, min_score=0.0)",
         'TextEmbeddingIndexSettings(model, min_score=0.0, device="cpu")'),
    ),
    "test_native_results.py": (
        ("create_test_embedding_model(16), min_score=0.0",
         'create_test_embedding_model(16), min_score=0.0, device="cpu"'),
    ),
}

MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)


def test_every_suite_test_is_mirrored_or_excluded():
    """Each test of each suite is a case here or stands in EXCLUDED with
    its reason; nothing else is left out."""
    check_mirrored(SUITES, EXCLUDED, MIRRORED)
