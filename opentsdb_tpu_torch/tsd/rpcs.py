"""The ingest and query RPC handlers: put, rollup, histogram, query.

Port of the put, rollup, histogram and query handlers of
opentsdb_tpu/tsd/rpcs.py (OpenTSDB src/tsd/PutDataPointRpc.java: telnet
`put` :129, POST /api/put :272, processDataPoint :309 with its details
and summary modes; RollupDataPointRpc (:340); HistogramDataPointRpc;
QueryRpc.java :89: the GET
query-string grammar and the POST JSON body).  Telnet puts are handled
one line at a time; the reference's batched native put is a speed mode
over its C++ engine, with the same answers, and is not ported.  The
/api/query sub-endpoints last, exp and gexp, and deleting data through a
query, answer 501 naming the ROADMAP slice that ports them.
/api/query/explain answers the routing verdict of a query without
running it (``handle_explain``, query/explain.py): no admission permit,
no kernel, bounded by the request's deadline.  A
query passes the admission gate (tsd/admission.py, the reference's
rpcs.py:484) before the runner and releases its permit after its
response is written; a shed answers 503 with Retry-After, a degraded
answer is a 200 whose trailer carries ``partialResults``.  The handlers
mark their request's phases (obs/latattr.py: parse, dispatch, serialize)
where the reference does (:201, :227, :278, :478, :542), and a query's
serialization is a span of its trace; ``show_stats`` carries the trace
in the summary.
"""

from __future__ import annotations

import contextlib

from opentsdb_tpu_torch.models.tsquery import (
    TSQuery, parse_m_subquery, parse_tsuid_subquery)
from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.tsd import admission
from opentsdb_tpu_torch.tsd.http import (BadRequestError, HttpQuery,
                                         NotPortedError)
from opentsdb_tpu_torch.uid import NoSuchUniqueName


class TelnetRpc:
    def execute_telnet(self, tsdb, conn, words: list[str]) -> str | None:
        raise NotImplementedError


class HttpRpc:
    def execute_http(self, tsdb, query: HttpQuery) -> None:
        raise NotImplementedError


def allowed_methods(query: HttpQuery, *methods: str) -> None:
    if query.method not in methods:
        raise BadRequestError(
            "Method not allowed", status=405,
            details="The HTTP method [%s] is not permitted for this endpoint"
                    % query.method)


def parse_tags(words: list[str]) -> dict[str, str]:
    """`tag=value` words -> dict (Tags.parse)."""
    tags: dict[str, str] = {}
    for w in words:
        if not w:
            continue
        if "=" not in w:
            raise ValueError("invalid tag: %s" % w)
        k, v = w.split("=", 1)
        if not k or not v:
            raise ValueError("invalid tag: %s" % w)
        if tags.get(k, v) != v:
            raise ValueError("duplicate tag: %s, tags so far: %s" % (w, tags))
        tags[k] = v
    return tags


def parse_telnet_timestamp(text: str) -> float:
    if not text:
        raise ValueError("empty timestamp")
    ts = float(text) if "." in text else int(text)
    if ts <= 0:
        raise ValueError("invalid timestamp: %s" % text)
    return ts


class PutDataPointRpc(TelnetRpc, HttpRpc):
    """Telnet `put` + POST /api/put.  The reference's per-RPC counters
    feed /api/stats, which is not ported."""

    # -- telnet: put <metric> <ts> <value> <tag=v> [...] --

    def execute_telnet(self, tsdb, conn, words: list[str]) -> str | None:
        try:
            self.import_telnet_point(tsdb, words)
            return None
        except NoSuchUniqueName as e:
            return "put: unknown metric: %s\n" % e
        except ValueError as e:
            return "put: %s\n" % e
        except Exception as e:
            return "put: %s: %s\n" % (type(e).__name__, e)

    def import_telnet_point(self, tsdb, words: list[str]) -> None:
        if len(words) < 5:
            raise ValueError("not enough arguments (need least 4, got %d)"
                             % (len(words) - 1))
        metric = words[1]
        if not metric:
            raise ValueError("empty metric name")
        timestamp = parse_telnet_timestamp(words[2])
        value = words[3]
        if not value:
            raise ValueError("empty value")
        tags = parse_tags(words[4:])
        tsdb.add_point(metric, timestamp, value, tags)

    # -- HTTP --

    def execute_http(self, tsdb, query: HttpQuery) -> None:
        allowed_methods(query, "POST")
        dps = query.serializer.parse_put_v1()
        latattr.mark("parse")
        if not dps:
            raise BadRequestError("No datapoints found in content")
        success, errors = self.ingest_points(tsdb, dps)
        latattr.mark("dispatch")
        self._respond_put(query, success, errors, dps)

    def ingest_points(self, tsdb, dps: list[dict]
                      ) -> tuple[int, list[tuple[int, Exception]]]:
        """(success, [(index, exception)]): points validate one by one
        and land as one columnar batch per series."""
        return tsdb.add_points_bulk(dps)

    def _respond_put(self, query: HttpQuery, success: int, errors: list,
                     dps: list[dict]) -> None:
        """The 204 / details / summary answer."""
        show_details = query.has_query_string_param("details")
        show_summary = query.has_query_string_param("summary")
        details: list[dict] = []
        for i, e in errors:
            if isinstance(e, NoSuchUniqueName):
                details.append({"error": "Unknown metric",
                                "datapoint": dps[i]})
            elif isinstance(e, (ValueError, TypeError)):
                details.append({"error": str(e), "datapoint": dps[i]})
            else:
                details.append({"error": "Storage exception: %s" % e,
                                "datapoint": dps[i]})
        if not show_details and not show_summary:
            if errors:
                raise BadRequestError(
                    "One or more data points had errors",
                    details="Please see the TSD logs or append \"details\" "
                            "to the put request")
            query.send_status_only(204)
            return
        summary = {"success": success, "failed": len(errors)}
        if show_details:
            summary["errors"] = details
        query.send_reply(query.serializer.format_put_v1(summary),
                         status=200 if not errors else 400)


class _OneByOneRpc(PutDataPointRpc):
    """An ingest RPC whose points land one at a time through
    ``store_point`` (the reference's _ingest_one_by_one, rpcs.py:257)."""

    def ingest_points(self, tsdb, dps):
        success = 0
        errors: list[tuple[int, Exception]] = []
        for i, dp in enumerate(dps):
            try:
                self.store_point(tsdb, dp)
                success += 1
            except Exception as e:
                errors.append((i, e))
        return success, errors

    def store_point(self, tsdb, dp: dict) -> None:
        raise NotImplementedError


class RollupDataPointRpc(_OneByOneRpc):
    """Telnet `rollup` + POST /api/rollup (RollupDataPointRpc.java).

    Telnet grammar (:95-150): ``rollup <interval>-<agg>[:<spatial_agg>]
    metric ts value tag=v...``, or ``rollup <spatial_agg> ...`` for an
    interval-less pre-aggregate."""

    def import_telnet_point(self, tsdb, words: list[str]) -> None:
        if len(words) < 6:
            raise ValueError("not enough arguments (need least 5, got %d)"
                             % (len(words) - 1))
        interval_agg = words[1]
        if not interval_agg:
            raise ValueError("Missing interval or aggregator")
        interval, temporal_agg, spatial_agg = parse_interval_agg(interval_agg)
        metric = words[2]
        if not metric:
            raise ValueError("empty metric name")
        timestamp = parse_telnet_timestamp(words[3])
        value = words[4]
        if not value:
            raise ValueError("empty value")
        tags = parse_tags(words[5:])
        tsdb.add_aggregate_point(metric, timestamp, value, tags,
                                 spatial_agg is not None, interval,
                                 temporal_agg, spatial_agg)

    def store_point(self, tsdb, dp: dict) -> None:
        for field in ("metric", "timestamp", "value", "tags"):
            if field not in dp or dp[field] in (None, "", {}):
                raise ValueError("Missing required field: %s" % field)
        interval = dp.get("interval")
        agg = dp.get("aggregator") or dp.get("aggregate")
        groupby = dp.get("groupbyAggregator") or dp.get("groupby_aggregator")
        is_groupby = bool(dp.get("groupby", groupby is not None))
        tsdb.add_aggregate_point(dp["metric"], dp["timestamp"], dp["value"],
                                 dict(dp["tags"]), is_groupby, interval,
                                 agg, groupby or agg)


def parse_interval_agg(interval_agg: str
                       ) -> tuple[str | None, str | None, str | None]:
    """"1h-sum", "1h-sum:count", or a bare "sum"
    (RollupDataPointRpc.java:108-123) -> (interval, temporal, spatial)."""
    parts = interval_agg.split(":")
    interval = temporal = spatial = None
    dash = parts[0].find("-")
    if dash > -1:
        interval = parts[0][:dash]
        temporal = parts[0][dash + 1:]
    elif len(parts) == 1:
        spatial = parts[0]
    if len(parts) > 1:
        spatial = parts[1]
    return interval, temporal, spatial


class HistogramDataPointRpc(_OneByOneRpc):
    """Telnet `histogram` + POST /api/histogram."""

    def import_telnet_point(self, tsdb, words: list[str]) -> None:
        # histogram <codec_id> <metric> <ts> <base64 or json value> tag=v...
        if len(words) < 6:
            raise ValueError("not enough arguments (need least 5, got %d)"
                             % (len(words) - 1))
        if tsdb.histogram_manager is None:
            raise ValueError("histograms are not configured "
                             "(tsd.core.histograms.config)")
        codec_id = int(words[1])
        metric = words[2]
        timestamp = parse_telnet_timestamp(words[3])
        tags = parse_tags(words[5:])
        tsdb.add_histogram_point_raw(metric, timestamp, codec_id, words[4],
                                     tags)

    def store_point(self, tsdb, dp: dict) -> None:
        if tsdb.histogram_manager is None:
            raise ValueError("histograms are not configured "
                             "(tsd.core.histograms.config)")
        for field in ("metric", "timestamp", "tags"):
            if field not in dp or dp[field] in (None, "", {}):
                raise ValueError("Missing required field: %s" % field)
        tsdb.add_histogram_point_json(dp["metric"], dp["timestamp"], dp,
                                      dict(dp["tags"]))


# /api/query sub-endpoints the port does not serve yet: the ROADMAP slice
# of queue A that ports each
_ADMIN_DATA = "A, slices 10 on (admin and data endpoints)"
_EXPRESSIONS = "A, slices 10 on (expressions)"
_NOT_PORTED = {"last": _ADMIN_DATA, "exp": _EXPRESSIONS,
               "gexp": _EXPRESSIONS}


class QueryRpc(HttpRpc):
    """/api/query, GET and POST."""

    def execute_http(self, tsdb, query: HttpQuery) -> None:
        sub = query.api_subpath()
        endpoint = sub[0] if sub else ""
        if endpoint in _NOT_PORTED:
            raise NotPortedError("/api/query/%s is not ported yet "
                                 "(ROADMAP %s)"
                                 % (endpoint, _NOT_PORTED[endpoint]))
        if endpoint == "explain":
            self.handle_explain(tsdb, query)
            return
        self.handle_query(tsdb, query)

    def handle_query(self, tsdb, query: HttpQuery) -> None:
        allowed_methods(query, "GET", "POST", "DELETE")
        if query.method == "POST":
            ts_query = query.serializer.parse_query_v1()
        else:
            ts_query = self.parse_query_string(query)
        if query.method == "DELETE" or ts_query.delete:
            if not tsdb.config.get_bool("tsd.http.query.allow_delete"):
                raise BadRequestError(
                    "Deleting data is not enabled",
                    details="Set tsd.http.query.allow_delete=true")
            raise NotPortedError("deleting data through /api/query is "
                                 "not ported yet (ROADMAP %s)" % _ADMIN_DATA)
        ts_query.validate()
        latattr.mark("parse")
        # admission (tsd/admission.py) before any device work: a shed
        # raises 503 with Retry-After; the degradation ladder may coarsen
        # or cut ts_query.  The permit is held until the response is
        # written, so the next queued query cannot start before this one
        # has left the socket: under the server, which writes the reply
        # after this handler returns, the request's after-write hooks
        # release it once the bytes are drained; called directly, the
        # handler's exit releases it.
        permit = admission.admit(tsdb, ts_query, query)
        after_write = getattr(query.request, "after_write", None)
        if after_write is not None:
            after_write.append(permit.release)
        with permit if after_write is None else contextlib.nullcontext():
            results = tsdb.new_query_runner().run(ts_query)
            with obs_trace.stage("serialize") as ssp:
                payload = query.serializer.format_query_v1(ts_query,
                                                           results)
                obs_trace.annotate(ssp, results=len(payload))
            latattr.mark("serialize")
            partial = None
            if permit.degrade_note:
                # the 200 says out loud that the ladder degraded it
                partial = admission.partial_annotation(
                    {"partialResults": True,
                     "degraded": permit.degrade_note})
                payload.append(partial)
            if ts_query.show_summary or ts_query.show_stats:
                summary = {
                    "datapoints": sum(len(r.dps) for r in results),
                    "queryTime": round(query.elapsed_ms(), 3),
                }
                if partial:
                    summary.update(partial)
                trace = obs_trace.active()
                if trace is not None and ts_query.show_stats:
                    # the span tree as of now: the http root is still
                    # open and renders its elapsed time
                    summary["trace"] = trace.to_json()
                payload.append({"statsSummary": summary})
            query.send_reply(payload)

    def handle_explain(self, tsdb, query: HttpQuery) -> None:
        """/api/query/explain (the reference's :609-660): the /api/query
        request, GET or POST, plus what-ifs (``what_if=key=value`` query
        parameters, or a ``whatIf`` object in the POST body), answered
        with the routing verdict of each sub query; 404 when
        ``tsd.explain.enable`` is off, 400 on a what-if the grammar or the
        port refuses.  It takes no admission permit, so an overloaded
        daemon can still be explained; the request deadline still bounds
        the walk."""
        allowed_methods(query, "GET", "POST")
        if not tsdb.config.get_bool("tsd.explain.enable"):
            raise BadRequestError(
                "The explain endpoint is disabled", status=404,
                details="Set tsd.explain.enable=true")
        from opentsdb_tpu_torch.query import explain
        if query.method == "POST":
            ts_query = query.serializer.parse_query_v1()
            raw_what_if = query.json_body().get("whatIf") or {}
            if not isinstance(raw_what_if, dict):
                raise BadRequestError("whatIf must be a JSON object")
        else:
            ts_query = self.parse_query_string(query)
            raw_what_if = {}
            for spec in query.get_query_string_params("what_if"):
                if "=" not in spec:
                    raise BadRequestError(
                        "what_if must be key=value, got %r" % spec)
                key, value = spec.split("=", 1)
                raw_what_if[key.strip()] = value
        ts_query.validate()
        latattr.mark("parse")
        try:
            what_if = explain.parse_what_if(raw_what_if)
        except explain.WhatIfError as e:
            raise BadRequestError(str(e))
        with obs_trace.stage("explain") as span:
            report = explain.explain_query(tsdb, ts_query, what_if)
            obs_trace.annotate(span, sub_queries=len(report["subQueries"]),
                               what_if=what_if.active)
        # the whole walk is the request's plan phase
        latattr.mark("plan")
        query.send_reply(report)

    @staticmethod
    def parse_query_string(query: HttpQuery) -> TSQuery:
        """GET grammar (QueryRpc.parseQuery :521-535)."""
        ts_query = TSQuery(
            start=query.required_query_string_param("start"),
            end=query.get_query_string_param("end"),
            timezone=query.get_query_string_param("tz"),
            ms_resolution=query.has_query_string_param("ms"),
            show_tsuids=query.has_query_string_param("show_tsuids"),
            no_annotations=query.has_query_string_param("no_annotations"),
            global_annotations=query.has_query_string_param(
                "global_annotations"),
            show_summary=query.has_query_string_param("show_summary"),
            show_stats=query.has_query_string_param("show_stats"),
            show_query=query.has_query_string_param("show_query"),
            padding=query.has_query_string_param("padding"),
            use_calendar=query.has_query_string_param("use_calendar"),
        )
        for m in query.get_query_string_params("m"):
            ts_query.queries.append(parse_m_subquery(m))
        for t in query.get_query_string_params("tsuid"):
            ts_query.queries.append(parse_tsuid_subquery(t))
        if not ts_query.queries:
            raise BadRequestError.missing_parameter("m or tsuid")
        return ts_query
