"""``tests/test_episode53_mutation_differential.py`` run against the port
(``test_torch_episode53.py`` says how; a file of its own, since its
``conversation`` fixture shares the golden-batch suite's name). It needs
the reference Episode-53 corpus and skips without it, as in the JAX run.
"""

from test_torch_episode53 import carry_module_marks
from test_torch_query_suites import check_mirrored, mirror

SUITES = ("test_episode53_mutation_differential.py",)
EXCLUDED: dict = {}
REWRITE = {
    "test_episode53_mutation_differential.py": (
        ("ev.load_episode53_conversation()", 'ev.load_episode53_conversation(device="cpu")'),
    ),
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)
carry_module_marks(SUITES, MIRRORED, globals())


def test_every_mutation_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)
