"""HTTP request/response primitives + the HttpQuery handler context.

A copy of opentsdb_tpu/tsd/http.py (OpenTSDB src/tsd/AbstractHttpQuery.java
+ HttpQuery.java): query-string access, API versioning (`/api/v1/...`,
explodeAPIPath), serializer selection, sendReply/sendError with standard
cache headers, and BadRequestException carrying {code, message, details}
(BadRequestException.java).
"""

from __future__ import annotations

import json
import time
import traceback
from dataclasses import dataclass, field
from urllib.parse import urlsplit, parse_qs, unquote

from opentsdb_tpu_torch.query.limits import QueryException
from opentsdb_tpu_torch.uid import NoSuchUniqueName, NoSuchUniqueId

HTTP_STATUS_TEXT = {
    200: "OK", 204: "No Content", 301: "Moved Permanently", 302: "Found",
    304: "Not Modified", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 413: "Request Entity Too Large",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


class BadRequestError(Exception):
    """HTTP error with status + user message + details (BadRequestException)."""

    def __init__(self, message: str, status: int = 400, details: str = ""):
        super().__init__(message)
        self.status = status
        self.message = message
        self.details = details

    @staticmethod
    def missing_parameter(name: str) -> "BadRequestError":
        return BadRequestError("Missing parameter <code>%s</code>" % name)


class NotPortedError(BadRequestError):
    """The 501 of an endpoint or option the port does not serve yet: a
    deliberate verdict naming the ROADMAP item that ports it, not an
    internal failure."""

    def __init__(self, details: str):
        super().__init__("The requested API endpoint has not been "
                         "implemented", status=501, details=details)


@dataclass
class HttpRequest:
    """One parsed HTTP/1.1 request."""
    method: str
    uri: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    version: str = "HTTP/1.1"

    @property
    def path(self) -> str:
        return urlsplit(self.uri).path

    @property
    def query(self) -> dict[str, list[str]]:
        return parse_qs(urlsplit(self.uri).query, keep_blank_values=True)

    def header(self, name: str) -> str | None:
        return self.headers.get(name.lower())


@dataclass
class HttpResponse:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def to_bytes(self, keep_alive: bool = True) -> bytes:
        reason = HTTP_STATUS_TEXT.get(self.status, "Unknown")
        head = ["HTTP/1.1 %d %s" % (self.status, reason)]
        headers = dict(self.headers)
        headers.setdefault("Content-Length", str(len(self.body)))
        if self.status != 204:
            headers.setdefault("Content-Type", "application/json")
        headers.setdefault("Connection",
                           "keep-alive" if keep_alive else "close")
        for k, v in headers.items():
            head.append("%s: %s" % (k, v))
        return ("\r\n".join(head) + "\r\n\r\n").encode() + self.body


class HttpQuery:
    """Handler-facing request context (HttpQuery.java / AbstractHttpQuery).

    Wraps the request, resolves the API version from `/api/v{N}/...` paths,
    exposes query-string helpers, and captures the response the handler
    sends.  One instance per request; never shared.
    """

    def __init__(self, tsdb, request: HttpRequest, remote: str = "unknown"):
        self.tsdb = tsdb
        self.request = request
        self.remote = remote
        self.start_time = time.time()
        self.response: HttpResponse | None = None
        self.api_version = 0
        self._route = self._explode_api_path()
        self.serializer = None   # set by RpcManager from tsd.http.serializer
        self.show_stack_trace = (
            tsdb is not None
            and tsdb.config.get_bool("tsd.http.show_stack_trace"))

    # -- path / routing (AbstractHttpQuery.getQueryBaseRoute,
    #    HttpQuery.explodeAPIPath) --

    def _explode_api_path(self) -> str:
        path = self.request.path.lstrip("/")
        parts = path.split("/")
        if parts and parts[0] == "api":
            if len(parts) > 1 and parts[1][:1] == "v" and \
                    parts[1][1:].isdigit():
                self.api_version = int(parts[1][1:])
                parts = ["api"] + parts[2:]
                path = "/".join(parts)
            else:
                self.api_version = 1
        return path

    @property
    def path(self) -> str:
        """Versionless path, e.g. "api/query/last"."""
        return self._route

    def base_route(self) -> str:
        """First one or two path components, the RpcManager routing key."""
        parts = self._route.split("/")
        if parts[0] == "api" and len(parts) > 1:
            return "api/" + parts[1]
        return parts[0]

    def api_subpath(self) -> list[str]:
        """Path components after the base route (e.g. uid endpoints)."""
        parts = self._route.split("/")
        if parts[0] == "api":
            return parts[2:]
        return parts[1:]

    @property
    def method(self) -> str:
        return self.request.method

    # -- query string helpers (AbstractHttpQuery:163-230) --

    def get_query_string_param(self, name: str) -> str | None:
        vals = self.request.query.get(name)
        return vals[-1] if vals else None

    def get_query_string_params(self, name: str) -> list[str]:
        return self.request.query.get(name, [])

    def has_query_string_param(self, name: str) -> bool:
        return name in self.request.query

    def required_query_string_param(self, name: str) -> str:
        value = self.get_query_string_param(name)
        if value is None or value == "":
            raise BadRequestError.missing_parameter(name)
        return value

    # -- body helpers --

    def json_body(self):
        if not self.request.body:
            raise BadRequestError("Missing request content")
        try:
            return json.loads(self.request.body)
        except json.JSONDecodeError as e:
            raise BadRequestError("Unable to parse the given JSON",
                                  details=str(e))

    # -- replies (AbstractHttpQuery.sendReply/sendStatusOnly/sendBuffer) --

    def send_reply(self, body, status: int = 200,
                   content_type: str = "application/json") -> None:
        if isinstance(body, (dict, list)):
            jsonp = self.get_query_string_param("jsonp")
            text = json.dumps(body)
            if jsonp:
                text = "%s(%s)" % (jsonp, text)
                content_type = "text/javascript"
            body = text.encode()
        elif isinstance(body, str):
            body = body.encode()
        self.response = HttpResponse(
            status=status, body=body,
            headers={"Content-Type": content_type})

    def send_status_only(self, status: int) -> None:
        self.response = HttpResponse(status=status)

    def send_error(self, exc: Exception) -> None:
        """Standard error envelope {error: {code, message, details,
        trace?}} (HttpJsonSerializer.formatErrorV1)."""
        status = error_status(exc)
        if isinstance(exc, BadRequestError):
            message, details = exc.message, exc.details
        else:
            # QueryException carries an optional structured payload
            # (grid-budget 413s: computed MB, limit, suggested config)
            message = str(exc) or repr(exc)
            details = getattr(exc, "details", None) or ""
        err = {"code": status, "message": message}
        if details:
            err["details"] = details
        if self.show_stack_trace:
            err["trace"] = "".join(traceback.format_exception(exc))
        self.send_reply({"error": err}, status=status)
        retry_after = getattr(exc, "retry_after_s", None)
        if retry_after:
            # admission-shed 503s tell the client WHEN to come back
            # (tsd/admission.py ShedError)
            self.response.headers["Retry-After"] = str(int(retry_after))

    def elapsed_ms(self) -> float:
        return (time.time() - self.start_time) * 1000.0

    def effective_method(self) -> str:
        """HTTP method honoring the method_override query param
        (HttpQuery.getAPIMethod)."""
        override = self.get_query_string_param("method_override")
        return (override or self.method).upper()


def error_status(exc: Exception) -> int:
    """HTTP status for an exception: name-lookup misses are 404, user input
    errors 400 (KeyError from malformed bodies included), budget/timeout
    rejections carry their own status (413, SaltScanner.java:564-601), the
    rest 500."""
    if isinstance(exc, BadRequestError):
        return exc.status
    if isinstance(exc, QueryException):
        return exc.status
    if isinstance(exc, (NoSuchUniqueName, NoSuchUniqueId)):
        return 404
    if isinstance(exc, (ValueError, KeyError, IndexError, TypeError)):
        return 400
    return 500


def parse_http_head(data: bytes) -> tuple[HttpRequest, int] | None:
    """Parse request line + headers from a buffer.

    Returns (request-without-body, header_end_offset) or None when the
    buffer does not yet hold the full header block.
    """
    end = data.find(b"\r\n\r\n")
    sep = 4
    if end < 0:
        end = data.find(b"\n\n")
        sep = 2
        if end < 0:
            return None
    head = data[:end].decode("latin-1")
    lines = head.splitlines()
    if not lines:
        raise BadRequestError("Empty request")
    parts = lines[0].split(" ")
    if len(parts) < 3:
        raise BadRequestError("Malformed request line: %r" % lines[0])
    method, uri, version = parts[0], parts[1], parts[2]
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return (HttpRequest(method=method.upper(), uri=unquote_safe(uri),
                        headers=headers, version=version), end + sep)


def unquote_safe(uri: str) -> str:
    """Decode %-escapes in the path but preserve the query string raw
    (parse_qs decodes it per-parameter)."""
    split = urlsplit(uri)
    path = unquote(split.path)
    if split.query:
        return path + "?" + split.query
    return path
