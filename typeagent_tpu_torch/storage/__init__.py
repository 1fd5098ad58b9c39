"""Storage backends of the port: in-memory and SQLite."""
