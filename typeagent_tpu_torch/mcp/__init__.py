"""MCP (Model Context Protocol) serving layer (the port of ``typeagent_tpu/mcp/``)."""
