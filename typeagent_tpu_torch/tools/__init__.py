"""Command-line tools: query REPL, ingestion, repair and health checks,
evals, benchmarks and key sync.

The port of ``typeagent_tpu/tools/``, every module of it: ``ingest_vtt``,
``ingest_podcast``, ``ingest_email``, ``load_json``, ``query``,
``reextract``, ``doctor``, ``chat_sessions``, the evals ``eval_golden``,
``eval_episode53`` and ``compare_evals``, the seven ``benchmark_*`` tools,
``get_keys`` and ``mail/`` (``dump_mbox``, ``print_timestamps``,
``dump_gmail``, ``dump_outlook``). The cloud tools speak REST through
``rest.py`` (the standard library's ``http.client``). Each tool that
builds a conversation or a store takes ``--device {cuda,cpu}``, the
port's counterpart of the JAX package's platform setting: where the
embedding indexes live (the card unless ``cpu`` is named; without a card
the settings raise).
"""

import argparse


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    """``--device {cuda,cpu}``: the conversation settings' device."""
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the embedding indexes live (default: cuda, the card)",
    )
