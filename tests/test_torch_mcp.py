"""The MCP server of the port against the JAX package's.

``tests/test_mcp.py`` runs against the port through
``test_torch_query_suites.mirror``, nothing excluded, with three texts
rewritten: the port's server is spawned with ``--device cpu`` (its
default is the card), ``build_server`` is given ``device="cpu"`` the same
way, and the subprocesses that build its databases import no JAX and
build their settings on the CPU.

Then one JSON-RPC script (initialize, the lists, resources, prompts, two
``query_conversation`` and two ``query_corpus`` calls, the error surface)
runs against both packages' servers, spawned over stdio on two podcast
databases each package built from the same seed-made transcripts
(``test:16`` embeddings, no extraction). The client answers the servers'
sampling requests with the canned logic of ``models/canned.py``; every
response and every sampling request must be equal between the two.
"""

import asyncio
import json
import os
import sys

import numpy as np

from test_torch_fake_endpoint import McpClient, canned_responder
from test_torch_query_suites import check_mirrored, mirror

SUITES = ("test_mcp.py",)
EXCLUDED: dict = {}
REWRITE = {
    "test_mcp.py": (
        # The port's entry points default to the card.
        ('"typeagent_tpu.mcp.server",', '"typeagent_tpu.mcp.server", "--device", "cpu",'),
        ('embedding_model="test:8",', 'embedding_model="test:8", device="cpu",'),
        # The database builders need no JAX on the port's side, and their
        # settings (inside a string, in single quotes) the CPU.
        ('"s = ConversationSettings(model=', '"s = ConversationSettings(device=\'cpu\', model='),
        ('" s = ConversationSettings(model=', '" s = ConversationSettings(device=\'cpu\', model='),
        ("\"import jax; jax.config.update('jax_platforms','cpu');\"", ""),
        ('"import jax\\n"\n                "jax.config.update(\'jax_platforms\',\'cpu\')\\n"', ""),
    )
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEAKERS = ("ALICE", "BOB", "CAROL", "DAVE")


def test_every_mcp_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


def _transcript(seed: int, turns: int) -> str:
    rng = np.random.default_rng(seed)
    words = [f"topic{i}" for i in range(40)] + ["music", "budget", "fugue", "organ"]
    lines = []
    for _ in range(turns):
        text = " ".join(rng.choice(words, rng.integers(6, 14)))
        lines.append(f"{SPEAKERS[rng.integers(0, len(SPEAKERS))]}: {text.capitalize()}.")
    return "\n".join(lines) + "\n"


_BUILD = (
    "import asyncio, sys\n"
    "pkg, src, db, device = sys.argv[1:]\n"
    "import importlib\n"
    "cs = importlib.import_module(pkg + '.knowpro.convsettings')\n"
    "ad = importlib.import_module(pkg + '.models.adapters')\n"
    "pi = importlib.import_module(pkg + '.podcasts.podcast_ingest')\n"
    "kw = {'device': device} if device != '-' else {}\n"
    "s = cs.ConversationSettings(model=ad.create_test_embedding_model(16), **kw)\n"
    "s.semantic_ref_index_settings.auto_extract_knowledge = False\n"
    "async def go():\n"
    "    pod = await pi.ingest_podcast(src, s, dbname=db)\n"
    "    await s.storage_provider.close()\n"
    "asyncio.run(go())\n"
)


QUESTIONS = {
    "What did Bob say about music?": {"searchExpressions": [{
        "rewrittenQuery": "What did Bob say about music?",
        "filters": [{"entitySearchTerms": [{"name": "Bob", "isNamePronoun": False}],
                     "searchTerms": ["music"]}]}]},
    "Who talked about the budget?": {"searchExpressions": [{
        "rewrittenQuery": "Who talked about the budget?", "filters": [{"searchTerms": ["budget"]}]}]},
    "Anything on xylophones?": {"searchExpressions": [{
        "rewrittenQuery": "Anything on xylophones?", "filters": [{"searchTerms": ["xylophone"]}]}]},
}
SCRIPT = [
    ("initialize", {"protocolVersion": "2024-11-05", "capabilities": {}, "clientInfo": {}}),
    ("tools/list", {}),
    ("tools/call", {"name": "query_conversation", "arguments": {"question": "What did Bob say about music?"}}),
    ("tools/call", {"name": "query_conversation", "arguments": {"question": "Anything on xylophones?"}}),
    ("tools/call", {"name": "query_corpus", "arguments": {"question": "Who talked about the budget?"}}),
    ("tools/call", {"name": "query_corpus", "arguments": {"question": "What did Bob say about music?",
                                                           "conversations": ["b"]}}),
    ("resources/list", {}),
    ("resources/read", {"uri": "conversation://info"}),
    ("resources/read", {"uri": "conversation://messages/recent"}),
    ("prompts/list", {}),
    ("prompts/get", {"name": "ask_conversation", "arguments": {"question": "Who spoke first?"}}),
    ("tools/call", {"name": "nope", "arguments": {}}),
    ("bogus/method", {}),
    ("ping", {}),
]


async def _run_script(pkg: str, tmp_path) -> tuple[list[dict], list[dict]]:
    # Each package's files under the same relative names (the server names
    # a conversation by its path), in a directory of its own.
    work = tmp_path / pkg
    work.mkdir()
    # One hash seed for every process: the podcast ingest lists a turn's
    # listeners from a set, in string-hash order, in both packages.
    env = dict(os.environ, TAT_JAX_PLATFORM="cpu", PYTHONPATH=REPO, PYTHONHASHSEED="0")
    device = "cpu" if pkg == "typeagent_tpu_torch" else "-"
    for name, seed in (("a", 1), ("b", 2)):
        src = tmp_path / f"pod_{name}.txt"
        if not src.exists():
            src.write_text(_transcript(seed, 40))
        build = await asyncio.create_subprocess_exec(
            sys.executable, "-c", _BUILD, pkg, str(src), f"{name}.db", device, env=env, cwd=work)
        assert await build.wait() == 0
    args = ["-d", "a.db", "--corpus", "a=a.db", "--corpus", "b=b.db", "--embedding-model", "test:16"]
    if pkg == "typeagent_tpu_torch":
        args += ["--device", "cpu"]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", f"{pkg}.mcp.server", *args, stdin=asyncio.subprocess.PIPE,
        stdout=asyncio.subprocess.PIPE, env=env, cwd=work)
    client = McpClient(proc, canned_responder(QUESTIONS))
    try:
        replies = [await client.request(method, params, timeout=120) for method, params in SCRIPT]
    finally:
        proc.stdin.close()
        try:
            await asyncio.wait_for(proc.wait(), 30)
        except TimeoutError:  # a call left awaiting its sampling answer
            proc.kill()
            await proc.wait()
            raise
    return replies, client.sampling


async def test_one_script_against_both_servers(tmp_path):
    jax_replies, jax_sampling = await _run_script("typeagent_tpu", tmp_path)
    port_replies, port_sampling = await _run_script("typeagent_tpu_torch", tmp_path)
    by_method = dict(zip([m for m, _ in SCRIPT], port_replies))
    assert [t["name"] for t in by_method["tools/list"]["result"]["tools"]] == ["query_corpus", "query_conversation"]
    calls = [r["result"] for (m, _), r in zip(SCRIPT, port_replies) if m == "tools/call"]
    assert [c["isError"] for c in calls] == [False, False, False, False, True]
    assert "Bob" in calls[0]["content"][0]["text"] or "bob" in calls[0]["content"][0]["text"]
    assert calls[1]["content"][0]["text"].startswith("No answer found")
    assert "[a]" in calls[2]["content"][0]["text"] and "[b]" in calls[2]["content"][0]["text"]
    assert "[a]" not in calls[3]["content"][0]["text"]
    assert port_sampling and len(port_sampling) == len(jax_sampling)
    for (method, _), j, p in zip(SCRIPT, jax_replies, port_replies):
        if method == "bogus/method":
            assert p["error"]["code"] == j["error"]["code"] == -32601
            continue
        assert p == j, method
    assert port_sampling == jax_sampling
