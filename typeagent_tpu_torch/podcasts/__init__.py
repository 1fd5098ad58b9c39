"""Podcast domain adapter (the port of ``typeagent_tpu/podcasts/``)."""

from .podcast import Podcast, PodcastMessage, PodcastMessageMeta
from .podcast_ingest import ingest_podcast

__all__ = ["Podcast", "PodcastMessage", "PodcastMessageMeta", "ingest_podcast"]
