"""HTTP request/response plumbing shared by the proxy and replicas.

The reference hands replicas a starlette ``Request`` built by uvicorn
(``serve/_private/http_util.py``); this environment has no ASGI stack, so
``Request`` is a small picklable equivalent assembled by the stdlib proxy
and shipped to the replica over the actor call.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl, urlsplit


class Request:
    """An HTTP request as seen by a deployment's ``__call__``.

    Mirrors the parts of starlette's Request that serve users touch:
    ``method``, ``path``, ``query_params``, ``headers``, ``body`` (bytes),
    and ``json()``.
    """

    def __init__(
        self,
        method: str = "GET",
        path: str = "/",
        query_params: Optional[Dict[str, str]] = None,
        headers: Optional[Dict[str, str]] = None,
        body: bytes = b"",
    ):
        self.method = method
        self.path = path
        self.query_params = query_params or {}
        self.headers = headers or {}
        self.body = body

    @classmethod
    def from_raw(cls, method: str, raw_path: str, headers: Dict[str, str], body: bytes) -> "Request":
        parts = urlsplit(raw_path)
        return cls(
            method=method,
            path=parts.path,
            query_params=dict(parse_qsl(parts.query)),
            headers=headers,
            body=body,
        )

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode("utf-8", errors="replace")

    def __repr__(self) -> str:
        return f"Request({self.method} {self.path}, {len(self.body)}B)"


class Response:
    """An explicit HTTP response from a deployment: status + headers +
    body.  The starlette ``Response`` seat — what the ``@serve.ingress``
    ASGI adapter returns, and what any deployment can return directly to
    control the status code.  Picklable (crosses the replica->proxy actor
    call)."""

    def __init__(self, body: Any = b"", status_code: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: Optional[str] = None):
        if isinstance(body, (bytes, bytearray)):
            self.body = bytes(body)
            default_ct = "application/octet-stream"
        elif isinstance(body, str):
            self.body = body.encode()
            default_ct = "text/plain; charset=utf-8"
        else:
            self.body = json.dumps(body).encode()
            default_ct = "application/json"
        self.status_code = int(status_code)
        self.headers = dict(headers or {})
        if content_type is not None:
            self.content_type = content_type
        else:
            self.content_type = self.headers.pop(
                "content-type", self.headers.pop("Content-Type", default_ct))

    def __repr__(self) -> str:
        return f"Response({self.status_code}, {len(self.body)}B)"


class StreamingResponse:
    """Return this from a deployment to stream the response body
    incrementally (the starlette StreamingResponse seat).  ``iterable``
    yields str/bytes chunks (anything else is JSON-encoded per chunk); the
    proxy delivers them with chunked transfer encoding as produced, pulling
    batches from the replica's stream registry."""

    def __init__(self, iterable, content_type: str = "text/plain"):
        self.iterable = iterable
        self.content_type = content_type


def encode_chunk(chunk: Any) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return (json.dumps(chunk) + "\n").encode()


def encode_response(result: Any) -> tuple:
    """(body_bytes, content_type) for an HTTP response, mirroring the
    reference proxy's str/bytes/json handling (``http_util.py`` Response)."""
    if isinstance(result, bytes):
        return result, "application/octet-stream"
    if isinstance(result, str):
        return result.encode(), "text/plain; charset=utf-8"
    return json.dumps(result).encode(), "application/json"


def run_asgi_app(app, request: Request) -> Response:
    """Run one request through an ASGI application and collect the reply.

    The environment has no uvicorn, so this is the ASGI *server* half in
    ~40 lines: build an ``http`` scope from our picklable Request, feed
    the body through ``receive``, fold ``http.response.start`` /
    ``http.response.body`` messages into a :class:`Response`.  Runs the
    app on a private event loop (the replica executes requests on plain
    threads) — what ``@serve.ingress`` calls per request.
    """
    import asyncio
    from urllib.parse import urlencode

    state: Dict[str, Any] = {"status": 500, "headers": [],
                             "body": bytearray()}
    fed = {"done": False}

    async def receive():
        if fed["done"]:
            # the app asked again after consuming the body: a one-shot
            # request has nothing more to say
            return {"type": "http.disconnect"}
        fed["done"] = True
        return {"type": "http.request", "body": request.body or b"",
                "more_body": False}

    async def send(message):
        t = message.get("type")
        if t == "http.response.start":
            state["status"] = int(message.get("status", 200))
            state["headers"] = list(message.get("headers") or [])
        elif t == "http.response.body":
            state["body"] += message.get("body", b"")

    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": request.path,
        "raw_path": request.path.encode("latin-1"),
        "query_string": urlencode(request.query_params).encode("latin-1"),
        "root_path": "",
        "headers": [(k.lower().encode("latin-1"), str(v).encode("latin-1"))
                    for k, v in request.headers.items()],
        "client": None,
        "server": None,
    }
    asyncio.run(app(scope, receive, send))
    headers = {}
    for k, v in state["headers"]:
        if isinstance(k, bytes):
            k = k.decode("latin-1")
        if isinstance(v, bytes):
            v = v.decode("latin-1")
        headers[k] = v
    return Response(bytes(state["body"]), status_code=state["status"],
                    headers=headers)


def parse_http_head(head: bytes) -> tuple:
    """Parse a raw request head (request line + header block, without the
    terminating blank line) into ``(method, raw_path, version, headers)``
    — the asyncio ingress's stand-in for http.server's parsing.  Header
    names keep the sender's ORIGINAL case (deployment code reading
    ``request.headers`` must see the same keys under both transports);
    callers needing case-insensitive lookups lowercase their own view.
    Raises ValueError on malformed input (the caller answers 400)."""
    lines = head.split(b"\r\n")
    try:
        method, raw_path, version = lines[0].decode("latin-1").split(" ", 2)
    except (UnicodeDecodeError, ValueError):
        raise ValueError(f"malformed request line: {lines[0][:80]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            raise ValueError(f"malformed header line: {line[:80]!r}")
        headers[k.decode("latin-1").strip()] = v.decode("latin-1").strip()
    return method, raw_path, version, headers
