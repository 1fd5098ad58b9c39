"""The JAX package's Episode-53 suites, run against the port.

``test_episode53_golden_batch.py``, ``test_episode53_ingest.py`` and
``test_reference_compat.py`` are mirrored onto the port by
``test_torch_query_suites.mirror`` (``test_episode53_mutation_differential.py``
in ``test_torch_episode53_mutation.py``: its fixture shares a name). They
replay the reference's Episode-53 corpus through the port's
``tools/eval_episode53.py`` against the committed
``tests/testdata/golden_episode53_search.json``. The corpus comes from a
checkout of the reference repository, which is not in this repository:
without it every test skips, as in the JAX run. Each suite's module-level
skip mark is carried onto its mirrored tests (``mirror`` copies functions,
not a module's ``pytestmark``). The eval's conversation is built on the
port's default device, the card, so the mirror names the CPU.
"""

import sys

from test_torch_query_suites import check_mirrored, mirror

SUITES = ("test_episode53_golden_batch.py", "test_episode53_ingest.py", "test_reference_compat.py")
EXCLUDED: dict = {}
REWRITE = {
    "test_episode53_golden_batch.py": (
        ("ev.load_episode53_conversation()", 'ev.load_episode53_conversation(device="cpu")'),
    ),
}


def carry_module_marks(suites, mirrored: dict[str, list[str]], namespace: dict) -> None:
    """Put each mirrored suite's module-level ``pytestmark`` on its tests
    (functions and classes) in ``namespace``."""
    for suite in suites:
        stem = suite[:-3]
        module = sys.modules[f"port_mirror_{stem}"]
        marks = getattr(module, "pytestmark", [])
        marks = marks if isinstance(marks, list) else [marks]
        for name in {n.split(".")[0] for n in mirrored[suite]}:
            key = f"test_{stem[5:]}__{name}" if name.startswith("test_") else f"Test_{stem[5:]}__{name}"
            for mark in marks:
                mark(namespace[key])


MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)
carry_module_marks(SUITES, MIRRORED, globals())


def test_every_episode53_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


def test_reference_corpus_is_read_only_where_the_setting_names(monkeypatch, tmp_path):
    """No default location: unset, the eval sees no corpus and the mirrored
    suites' reference paths lie in this checkout; set, both read there."""
    from test_torch_query_suites import TESTS, reference_file

    from typeagent_tpu_torch.tools import eval_episode53 as ev

    monkeypatch.delenv(ev.REFERENCE_ENV, raising=False)
    assert ev.reference_testdata() is None and ev.reference_file(ev.FIXTURE_NAME) is None
    assert not ev.corpus_available()
    assert reference_file("Parrot_Sketch.vtt").startswith(str(TESTS) + "/")
    (tmp_path / (ev.FIXTURE_NAME + "_data.json")).write_text("{}")
    (tmp_path / ev.QUERY_CORPUS_NAME).write_text("[]")
    monkeypatch.setenv(ev.REFERENCE_ENV, str(tmp_path))
    assert ev.corpus_available()
    assert ev.load_query_corpus() == []
    assert reference_file("Parrot_Sketch.vtt") == str(tmp_path / "Parrot_Sketch.vtt")
