"""Storage backends of the port: in-memory (SQLite is ROADMAP Queue 1 item 12)."""
