"""Load a JSON index snapshot into a SQLite database.

(Parity role: reference tools/load_json.py.)
The port of ``typeagent_tpu/tools/load_json.py``.
Run: ``python -m typeagent_tpu_torch.tools.load_json <prefix> <out.db>``.
"""

from __future__ import annotations

import argparse
import asyncio

from ..knowpro.convsettings import ConversationSettings
from ..knowpro.universal_message import ConversationMessage
from ..podcasts.podcast import Podcast
from ..storage.utils import create_storage_provider
from ..utils.misc import load_dotenv
from . import add_device_argument


async def load_json_to_sqlite(index_prefix: str, dbname: str, device: str = "cuda") -> None:
    settings = ConversationSettings(device=device)
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        ConversationMessage,
    )
    settings.storage_provider = provider
    async with provider:
        podcast = await Podcast.read_from_file(index_prefix, settings, dbname)
        print(
            f"Loaded {await podcast.messages.size()} messages and "
            f"{await podcast.semantic_refs.size()} semantic refs into {dbname}"
        )
    await provider.close()


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="JSON snapshot -> SQLite database")
    parser.add_argument("index_prefix", help="Snapshot prefix (<prefix>_data.json)")
    parser.add_argument("database", help="Output SQLite database path")
    add_device_argument(parser)
    args = parser.parse_args()
    asyncio.run(load_json_to_sqlite(args.index_prefix, args.database, args.device))


if __name__ == "__main__":
    main()
