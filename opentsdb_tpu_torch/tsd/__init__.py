"""The daemon's front end: one port serving the telnet line protocol and
HTTP/1.1, the route table and the handlers of the ported endpoints.

Port of the core of opentsdb_tpu/tsd/ (OpenTSDB src/tsd/).
"""

from opentsdb_tpu_torch.tsd.http import (
    HttpRequest, HttpResponse, HttpQuery, BadRequestError)
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.tsd.server import TSDServer

__all__ = ["HttpRequest", "HttpResponse", "HttpQuery", "BadRequestError",
           "RpcManager", "TSDServer"]
