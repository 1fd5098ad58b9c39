"""The email domain and the mail CLIs of the port against the JAX package's.

``tests/test_email_message_matrix.py`` runs against the port through
``test_torch_query_suites.mirror`` (nothing excluded). Then both packages'
``ingest_email`` read the same ``.eml`` files (``tests/testdata/sample.eml``
and seed-made ones from ``test_torch_conv_corpus.make_mailbox``: display
names, Cc, replies and forwards) into SQLite with the ``test:16``
embedding model and knowledge extraction through one loopback fake
(``test_torch_fake_endpoint.py``), in this process: the files' tables must
be equal, row for row in primary-key order as
``test_torch_sqlite_parity.py`` compares them, and the CLIs must print the
same lines. ``dump_mbox`` and ``print_timestamps`` must write and print
what the JAX tools do on a seed-made ``mbox``, and ``load_json`` must
read one snapshot into equal SQLite tables.
"""

import asyncio
import mailbox
import os
import shutil

import pytest

from test_torch_conv_corpus import email_text, make_mailbox
from test_torch_fake_endpoint import FakeEndpoint, canned_responder, point_models_at
from test_torch_query_suites import check_mirrored, mirror
from test_torch_sqlite_parity import _run_cli, tables

SUITES = ("test_email_message_matrix.py",)
EXCLUDED: dict = {}
MIRRORED = mirror(SUITES, EXCLUDED, globals())

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
SEED = 15
N_MAIL = 40


def test_every_email_matrix_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


@pytest.fixture
def mail_dir(tmp_path):
    path = tmp_path / "mail"
    path.mkdir()
    shutil.copy(os.path.join(TESTDATA, "sample.eml"), path / "sample.eml")
    for i, m in enumerate(make_mailbox(SEED, N_MAIL)):
        (path / f"m{i:03d}.eml").write_text(email_text(m))
    return path


def test_ingest_email_tables_match(mail_dir, tmp_path, monkeypatch):
    from typeagent_tpu.tools import ingest_email as j_ingest
    from typeagent_tpu_torch.tools import ingest_email

    out, dbs, chat = {}, {}, {}
    for name, module, extra in (("jax", j_ingest, []), ("port", ingest_email, ["--device", "cpu"])):
        dbs[name] = str(tmp_path / f"{name}.db")
        with FakeEndpoint(canned_responder()) as fake:
            point_models_at(fake, monkeypatch, "test:16")
            out[name] = _run_cli(module.main, ["ingest_email", str(mail_dir), "-d", dbs[name],
                                               "--batch-size", "7", "-v", *extra])
            chat[name] = fake.stats()["chat"]
    assert out["port"] == out["jax"]
    assert f"Ingested {N_MAIL + 1} emails" in out["port"]
    assert chat["port"] == chat["jax"] >= N_MAIL + 1  # one extraction per chunk
    assert tables(dbs["port"]) == tables(dbs["jax"])


def test_ingest_email_filters_and_dedupes_as_jax(mail_dir, tmp_path, monkeypatch):
    """A date window, offset and limit, then a second run that finds every
    source ingested: the same counts in both packages (no extraction)."""
    from typeagent_tpu.tools.ingest_email import ingest_emails as j_ingest_emails
    from typeagent_tpu_torch.tools.ingest_email import ingest_emails

    monkeypatch.setenv("OPENAI_EMBEDDING_MODEL", "test:16")
    sizes = {}
    for name, fn, kw in (("jax", j_ingest_emails, {}), ("port", ingest_emails, {"device": "cpu"})):
        db = str(tmp_path / f"{name}.db")
        runs = []
        for _ in range(2):
            memory = asyncio.run(fn(str(mail_dir), db, after="2024-03-01", before="2024-10-01",
                                    offset=3, limit=30, auto_extract=False, **kw))
            runs.append(asyncio.run(memory.messages.size()))
            asyncio.run(memory.storage_provider.close())
        sizes[name] = runs
    assert sizes["port"] == sizes["jax"]
    assert 0 < sizes["port"][0] == sizes["port"][1] < 30


def test_email_memory_aliases_and_noise_as_jax():
    from typeagent_tpu.emails import email_memory as j_memory
    from typeagent_tpu_torch.emails import email_memory

    for name in ("emailVerbs.json", "noiseTerms.txt"):
        with open(email_memory._data_file(name), "rb") as a, open(j_memory._data_file(name), "rb") as b:
            assert a.read() == b.read()
    port_noise, jax_noise = set(), set()
    email_memory.add_noise_words_from_file(port_noise, "noiseTerms.txt")
    j_memory.add_noise_words_from_file(jax_noise, "noiseTerms.txt")
    assert port_noise == jax_noise and "the" in port_noise


def test_email_knowledge_as_jax():
    """Every seed-made email's metadata knowledge, serialized, is the JAX
    package's."""
    from typeagent_tpu.emails.email_import import import_email_string as j_import
    from typeagent_tpu.knowpro.serialization import serialize_object as j_serialize
    from typeagent_tpu_torch.emails.email_import import import_email_string
    from typeagent_tpu_torch.knowpro.serialization import serialize_object

    for m in make_mailbox(SEED + 1, 60):
        text = email_text(m)
        port, jax = import_email_string(text), j_import(text)
        assert serialize_object(port) == j_serialize(jax)
        assert serialize_object(port.get_knowledge()) == j_serialize(jax.get_knowledge())


def test_dump_mbox_and_print_timestamps_as_jax(tmp_path):
    from typeagent_tpu.tools.mail import dump_mbox as j_dump, print_timestamps as j_pt
    from typeagent_tpu_torch.tools.mail import dump_mbox, print_timestamps

    box_path = str(tmp_path / "box.mbox")
    box = mailbox.mbox(box_path)
    raw = make_mailbox(SEED + 2, 25)
    for m in raw + raw[:3]:  # three exact duplicates
        box.add(email_text(m))
    box.flush()
    counts = {}
    for name, module in (("jax", j_dump), ("port", dump_mbox)):
        counts[name] = module.dump_mbox(box_path, str(tmp_path / name))
    assert counts["port"] == counts["jax"] == 25
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    port_out = _run_cli(print_timestamps.main, ["pt", str(tmp_path / "port")])
    jax_out = _run_cli(j_pt.main, ["pt", str(tmp_path / "jax")])
    assert port_out.replace(str(tmp_path / "port"), "<dir>") == jax_out.replace(str(tmp_path / "jax"), "<dir>")
    assert len(port_out.splitlines()) == 25


async def test_load_json_tables_match(tmp_path, monkeypatch):
    """``load_json`` reads one ``_data.json`` snapshot into SQLite in both
    packages: the tables are equal."""
    from test_torch_conv_corpus import make_corpus, port_conversation, write_snapshot
    from typeagent_tpu.tools.load_json import load_json_to_sqlite as j_load_json
    from typeagent_tpu_torch.tools.load_json import load_json_to_sqlite

    monkeypatch.setenv("OPENAI_EMBEDDING_MODEL", "test:16")
    conv, _ = await port_conversation(make_corpus(SEED + 3, 60))
    prefix = str(tmp_path / "snap")
    await write_snapshot(conv, prefix)
    await j_load_json(prefix, str(tmp_path / "jax.db"))
    await load_json_to_sqlite(prefix, str(tmp_path / "port.db"), device="cpu")
    assert tables(str(tmp_path / "port.db")) == tables(str(tmp_path / "jax.db"))
    assert len(tables(str(tmp_path / "port.db"))["Messages"]) == 60
