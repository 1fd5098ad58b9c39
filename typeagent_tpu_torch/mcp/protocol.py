"""Minimal MCP stdio server: JSON-RPC 2.0, newline-delimited messages.

Standalone replacement for the FastMCP dependency the reference uses
(`mcp/server.py`). Supports: initialize / ping / tools/list / tools/call /
resources/list / resources/read / prompts/list / prompts/get, plus
server->client requests (sampling/createMessage) with response routing —
the mechanism that lets the server borrow the CLIENT's LLM. (The reference
exposes only the single tool; resources and prompts are an extension.)

The port of ``typeagent_tpu/mcp/protocol.py`` (the standard library only,
the same code).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import sys
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable)

PROTOCOL_VERSION = "2024-11-05"

JSONRPC_PARSE_ERROR = -32700
JSONRPC_METHOD_NOT_FOUND = -32601
JSONRPC_INVALID_PARAMS = -32602
JSONRPC_INTERNAL_ERROR = -32603


@dataclass
class Tool:
    name: str
    description: str
    input_schema: dict
    handler: Callable


@dataclass
class Resource:
    uri: str
    name: str
    description: str
    mime_type: str
    handler: Callable  # async (server) -> str


@dataclass
class Prompt:
    name: str
    description: str
    arguments: list[dict]  # [{"name", "description", "required"}]
    handler: Callable  # async (server, **args) -> list[message dicts] | str


@dataclass
class McpServer:
    """A tiny MCP server over stdio."""

    name: str
    version: str = "0.1.0"
    instructions: str | None = None
    tools: dict[str, Tool] = field(default_factory=dict)
    resources: dict[str, Resource] = field(default_factory=dict)
    prompts: dict[str, Prompt] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._next_id = 1
        self._pending: dict[int, asyncio.Future] = {}
        self._writer_lock = asyncio.Lock()
        self._stdout = None
        self._initialized = False

    def tool(
        self, description: str, input_schema: dict | None = None
    ) -> Callable[[F], F]:
        """Decorator registering an async tool handler."""

        def register(fn):
            schema = input_schema
            if schema is None:
                # Derive a simple all-string schema from the signature.
                params = [
                    p
                    for p in inspect.signature(fn).parameters.values()
                    if p.name != "server"
                ]
                schema = {
                    "type": "object",
                    "properties": {p.name: {"type": "string"} for p in params},
                    "required": [
                        p.name for p in params if p.default is inspect.Parameter.empty
                    ],
                }
            self.tools[fn.__name__] = Tool(fn.__name__, description, schema, fn)
            return fn

        return register

    def resource(
        self,
        uri: str,
        name: str,
        description: str,
        mime_type: str = "text/plain",
    ) -> Callable[[F], F]:
        """Decorator registering an async resource reader: (server) -> str."""

        def register(fn):
            self.resources[uri] = Resource(uri, name, description, mime_type, fn)
            return fn

        return register

    def prompt(
        self, description: str, arguments: list[dict] | None = None
    ) -> Callable[[F], F]:
        """Decorator registering an async prompt builder.

        The handler returns either a string (one user message) or a list of
        MCP message dicts.
        """

        def register(fn):
            args = arguments
            if args is None:
                args = [
                    {"name": p.name, "required": p.default is inspect.Parameter.empty}
                    for p in inspect.signature(fn).parameters.values()
                    if p.name != "server"
                ]
            self.prompts[fn.__name__] = Prompt(fn.__name__, description, args, fn)
            return fn

        return register

    # -- transport ----------------------------------------------------------

    async def _send(self, message: dict) -> None:
        data = json.dumps(message)
        async with self._writer_lock:
            self._stdout.write((data + "\n").encode())
            await self._stdout.drain()

    async def request_client(self, method: str, params: dict) -> dict:
        """Send a server->client request and await its response."""
        request_id = self._next_id
        self._next_id += 1
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = future
        await self._send(
            {"jsonrpc": "2.0", "id": request_id, "method": method, "params": params}
        )
        try:
            return await future
        finally:
            self._pending.pop(request_id, None)

    async def create_message(
        self, messages: list[dict], max_tokens: int = 4096
    ) -> dict:
        """MCP sampling: ask the client's LLM for a completion."""
        return await self.request_client(
            "sampling/createMessage",
            {"messages": messages, "maxTokens": max_tokens},
        )

    # -- dispatch -----------------------------------------------------------

    async def _handle_request(self, message: dict) -> None:
        method = message.get("method")
        request_id = message.get("id")
        params = message.get("params") or {}
        try:
            match method:
                case "initialize":
                    capabilities: dict = {"tools": {}}
                    if self.resources:
                        capabilities["resources"] = {}
                    if self.prompts:
                        capabilities["prompts"] = {}
                    result = {
                        "protocolVersion": params.get(
                            "protocolVersion", PROTOCOL_VERSION
                        ),
                        "capabilities": capabilities,
                        "serverInfo": {"name": self.name, "version": self.version},
                    }
                    if self.instructions:
                        result["instructions"] = self.instructions
                    self._initialized = True
                case "ping":
                    result = {}
                case "tools/list":
                    result = {
                        "tools": [
                            {
                                "name": t.name,
                                "description": t.description,
                                "inputSchema": t.input_schema,
                            }
                            for t in self.tools.values()
                        ]
                    }
                case "tools/call":
                    result = await self._call_tool(
                        params.get("name"), params.get("arguments") or {}
                    )
                case "resources/list":
                    result = {
                        "resources": [
                            {
                                "uri": r.uri,
                                "name": r.name,
                                "description": r.description,
                                "mimeType": r.mime_type,
                            }
                            for r in self.resources.values()
                        ]
                    }
                case "resources/read":
                    uri = params.get("uri")
                    resource = self.resources.get(uri)
                    if resource is None:
                        raise ValueError(f"Unknown resource {uri!r}")
                    text = await resource.handler(self)
                    result = {
                        "contents": [
                            {
                                "uri": uri,
                                "mimeType": resource.mime_type,
                                "text": str(text),
                            }
                        ]
                    }
                case "prompts/list":
                    result = {
                        "prompts": [
                            {
                                "name": p.name,
                                "description": p.description,
                                "arguments": p.arguments,
                            }
                            for p in self.prompts.values()
                        ]
                    }
                case "prompts/get":
                    prompt = self.prompts.get(params.get("name"))
                    if prompt is None:
                        raise ValueError(f"Unknown prompt {params.get('name')!r}")
                    built = await prompt.handler(
                        self, **(params.get("arguments") or {})
                    )
                    if isinstance(built, str):
                        built = [
                            {
                                "role": "user",
                                "content": {"type": "text", "text": built},
                            }
                        ]
                    result = {
                        "description": prompt.description,
                        "messages": built,
                    }
                case _:
                    if request_id is not None:
                        await self._send(
                            {
                                "jsonrpc": "2.0",
                                "id": request_id,
                                "error": {
                                    "code": JSONRPC_METHOD_NOT_FOUND,
                                    "message": f"Unknown method {method!r}",
                                },
                            }
                        )
                    return
        except Exception as exc:
            if request_id is not None:
                await self._send(
                    {
                        "jsonrpc": "2.0",
                        "id": request_id,
                        "error": {
                            "code": JSONRPC_INTERNAL_ERROR,
                            "message": f"{type(exc).__name__}: {exc}",
                            "data": traceback.format_exc(limit=5),
                        },
                    }
                )
            return
        if request_id is not None:
            await self._send({"jsonrpc": "2.0", "id": request_id, "result": result})

    async def _call_tool(self, name: str, arguments: dict) -> dict:
        tool = self.tools.get(name)
        if tool is None:
            return {
                "content": [{"type": "text", "text": f"Unknown tool {name!r}"}],
                "isError": True,
            }
        try:
            output = await tool.handler(self, **arguments)
            return {
                "content": [{"type": "text", "text": str(output)}],
                "isError": False,
            }
        except Exception as exc:
            return {
                "content": [
                    {"type": "text", "text": f"{type(exc).__name__}: {exc}"}
                ],
                "isError": True,
            }

    def _handle_response(self, message: dict) -> None:
        future = self._pending.get(message.get("id"))
        if future is not None and not future.done():
            if "error" in message:
                future.set_exception(
                    RuntimeError(f"client error: {message['error']}")
                )
            else:
                future.set_result(message.get("result") or {})

    # -- main loop ----------------------------------------------------------

    async def run_stdio(self, stdin: Any = None, stdout: Any = None) -> None:
        """Serve newline-delimited JSON-RPC over stdio until EOF."""
        loop = asyncio.get_running_loop()
        if stdin is None or stdout is None:
            reader = asyncio.StreamReader()
            await loop.connect_read_pipe(
                lambda: asyncio.StreamReaderProtocol(reader), sys.stdin
            )
            transport, protocol = await loop.connect_write_pipe(
                asyncio.streams.FlowControlMixin, sys.stdout
            )
            writer = asyncio.StreamWriter(transport, protocol, None, loop)
            stdin, stdout = reader, writer
        self._stdout = stdout

        async with asyncio.TaskGroup() as tg:
            while True:
                line = await stdin.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    message = json.loads(line)
                except json.JSONDecodeError:
                    await self._send(
                        {
                            "jsonrpc": "2.0",
                            "id": None,
                            "error": {
                                "code": JSONRPC_PARSE_ERROR,
                                "message": "Parse error",
                            },
                        }
                    )
                    continue
                if "method" in message:
                    # Requests/notifications dispatch concurrently so a tool
                    # call can await sampling responses mid-flight.
                    tg.create_task(self._handle_request(message))
                else:
                    self._handle_response(message)
