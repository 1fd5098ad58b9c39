"""Command-line tools: query REPL, ingestion, repair and health checks.

The port of ``typeagent_tpu/tools/``: ``ingest_vtt``, ``ingest_podcast``,
``ingest_email``, ``load_json``, ``query``, ``reextract``, ``doctor`` and
``mail/`` (``dump_mbox``, ``print_timestamps``, which touch no device).
Each that builds a conversation takes ``--device {cuda,cpu}``,
the port's counterpart of the JAX package's platform setting: where the
conversation's embedding indexes live (the card unless ``cpu`` is named;
without a card the settings raise).
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
