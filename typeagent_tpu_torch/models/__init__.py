"""Embedding model interfaces and the deterministic offline embedder."""
