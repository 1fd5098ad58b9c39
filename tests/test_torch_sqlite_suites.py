"""The JAX package's SQLite-storage, transcript, podcast and CLI suites,
run against the port.

Each suite is read from its source with its imports pointed at
``typeagent_tpu_torch`` (and at the mirrored suites it imports from) by
``test_torch_query_suites.mirror``, and each test is put into this module
under ``test_<suite>__<test>``, on CPU tensors (``device="cpu"``, as there).
The tests the port cannot run are in :data:`EXCLUDED`, each with its
reason; :data:`DROPPED` names the module-level imports taken out for them
(none since the email domain and the mail tools were ported). The email
CLI's ``ingest_emails`` builds its settings on the port's default device,
the card, so the suites see it with ``device="cpu"``, as they see
``TextEmbeddingIndexSettings``; :data:`REWRITE` does the same for the
chat-sessions tool's ``ingest_session``.
"""

import functools
import sys

from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu_torch.tools.ingest_email import ingest_emails

SUITES = (
    "test_persistence.py",
    "test_storage_parity.py",
    "test_sqlite_indexes.py",
    "test_conversation_metadata.py",
    "test_embedding_consistency.py",
    "test_incremental.py",
    "test_vtt_parser_matrix.py",
    "test_transcripts_matrix.py",
    "test_domains.py",
    "test_tools.py",
    "test_property_laws.py",
)
_MAIL = (
    "feeds its pages to httpx through httpx.MockTransport; the port's mail "
    "dumpers speak REST through http.client (tools/rest.py), so its "
    "counterpart, test_torch_cloud_tools.py::test_tools__<this test's name>, "
    "serves the same pages from a loopback fake and asserts the same things"
)
DROPPED: dict[str, tuple[str, ...]] = {}
_NO_SETTINGS = (
    "opens SqliteStorageProvider without index settings, so the provider builds "
    "TextEmbeddingIndexSettings() over the default HTTP embedding model on the "
    "port's default device, the card; adapted below under its name with the "
    "test model's settings on the CPU"
)
EXCLUDED = {
    ("test_conversation_metadata.py", "test_embedding_model_mismatch_raises"): (
        "imports TextEmbeddingIndexSettings inside the test, so it builds its "
        "settings on the port's default device, the card; adapted below under "
        "its name with device='cpu'"
    ),
    ("test_conversation_metadata.py", "test_empty_string_timestamp_values_survive_roundtrip"): _NO_SETTINGS,
    ("test_conversation_metadata.py", "test_metadata_shared_access_two_handles"): _NO_SETTINGS,
    ("test_tools.py", "test_dump_gmail_roundtrip"): _MAIL,
    ("test_tools.py", "test_dump_gmail_token_refresh"): _MAIL,
    ("test_tools.py", "test_dump_outlook_roundtrip"): _MAIL,
    ("test_tools.py", "test_outlook_device_code_flow"): _MAIL,
    ("test_tools.py", "test_gmail_cached_token_respects_short_expiry"): _MAIL,
    ("test_tools.py", "test_outlook_safe_name_no_collisions_on_long_ids"): _MAIL,
}

# ingest_session builds its settings on the port's default device, the
# card: the two calls of the chat-sessions test name the CPU.
REWRITE = {
    "test_tools.py": (
        ("await ingest_session(session, db, None)", 'await ingest_session(session, db, None, device="cpu")'),
    ),
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), DROPPED, REWRITE)
sys.modules["port_mirror_test_tools"].ingest_emails = functools.partial(ingest_emails, device="cpu")


def test_every_sqlite_suite_test_is_mirrored_or_excluded():
    """Each test of each suite is a case here or stands in EXCLUDED with
    its reason; nothing else is left out."""
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


from port_mirror_test_conversation_metadata import make_provider  # noqa: E402


async def test_conversation_metadata__test_embedding_model_mismatch_raises(tmp_path):
    """Opening a DB with a different embedding model than stored must fail
    loudly (the JAX test, its settings on the CPU)."""
    import pytest

    from typeagent_tpu_torch.knowpro.convsettings import (
        MessageTextIndexSettings,
        RelatedTermIndexSettings,
    )
    from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage
    from typeagent_tpu_torch.models.adapters import create_embedding_model
    from typeagent_tpu_torch.storage.sqlite.provider import SqliteStorageProvider
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings

    db = str(tmp_path / "mm.db")

    class _RenamedModel:
        def __init__(self, inner, name):
            self._inner = inner
            self.model_name = name

        def __getattr__(self, attr):
            return getattr(self._inner, attr)

    def settings_for(spec, name):
        base = TextEmbeddingIndexSettings(
            embedding_model=create_embedding_model(spec), min_score=0.0, device="cpu"
        )
        base.embedding_model = _RenamedModel(base.embedding_model, name)
        return MessageTextIndexSettings(base), RelatedTermIndexSettings(base)

    mt, rt = settings_for("test:16", "model-alpha")
    provider = SqliteStorageProvider(
        db, ConversationMessage, None,
        message_text_index_settings=mt, related_term_index_settings=rt,
    )
    async with provider:
        pass
    await provider.close()

    mt2, rt2 = settings_for("test:16", "model-beta")
    with pytest.raises(ValueError, match="does not match"):
        SqliteStorageProvider(
            db, ConversationMessage, None,
            message_text_index_settings=mt2, related_term_index_settings=rt2,
        )


async def test_conversation_metadata__test_empty_string_timestamp_values_survive_roundtrip(tmp_path):
    """Oddball metadata values (empty strings) must not crash readback."""
    provider = make_provider(str(tmp_path / "odd.db"))
    async with provider:
        await provider.set_conversation_metadata(custom="", other="x")
    meta = await provider.get_conversation_metadata()
    assert meta.extra.get("custom") == ""
    assert meta.extra.get("other") == "x"
    await provider.close()


async def test_conversation_metadata__test_metadata_shared_access_two_handles(tmp_path):
    """Two providers on the same DB file observe each other's metadata
    writes (WAL mode)."""
    db = str(tmp_path / "shared.db")
    a = make_provider(db)
    async with a:
        await a.set_conversation_metadata(origin="writer-a")
    b = make_provider(db)
    meta = await b.get_conversation_metadata()
    assert meta.extra.get("origin") == "writer-a"
    await a.close()
    await b.close()
