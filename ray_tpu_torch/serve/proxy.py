"""The HTTP types of serve: what a deployment's ``__call__`` receives
(:class:`Request`) and may return to control the status and content type
(:class:`HTTPResponse`).

Counterpart of ``ray_tpu/serve/proxy.py``'s two request/response classes,
stdlib only. The proxy itself (the HTTP server routing requests to
deployments) comes with serve on the port's runtime (ROADMAP Queue 1 item
4); until then a caller builds a ``Request`` and hands it to the deployment
in-process or through an actor.
"""
from __future__ import annotations

import json
from typing import Any


class HTTPResponse:
    """Return one of these from a deployment's __call__ to control the HTTP
    status/content type (the default mapping JSON-encodes any other return
    value as 200). body: bytes or str."""

    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 422: "Unprocessable Entity",
                429: "Too Many Requests", 500: "Internal Server Error"}

    def __init__(self, status: int, body, content_type: str = "application/json"):
        self.status = int(status)
        self.body = body.encode() if isinstance(body, str) else bytes(body)
        self.content_type = content_type

    @property
    def status_line(self) -> str:
        return f"{self.status} {self._REASONS.get(self.status, 'Status')}"

    def __reduce__(self):
        return (HTTPResponse, (self.status, self.body, self.content_type))


class Request:
    """What an HTTP deployment's __call__ receives."""

    def __init__(self, method: str, path: str, query: dict, headers: dict, body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query, self.headers, self.body))
