"""The JSON serializer of the ported endpoints.

A slim port of opentsdb_tpu/tsd/serializers.py (OpenTSDB
src/tsd/HttpJsonSerializer.java: parsePutV1 :~200, parseQueryV1 :250,
formatQueryAsyncV1 :516 producing [{metric, tags, aggregateTags, tsuids?,
annotations?, dps}]), for the routes the port serves: /api/put,
/api/histogram, /api/query, /api/version and /api/aggregators.  A request
picks its serializer by the `serializer` query parameter; "json" is the
only one.
"""

from __future__ import annotations

from opentsdb_tpu_torch.models.tsquery import TSQuery, TSSubQuery
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.query.filters import build_filter, tags_to_filters
from opentsdb_tpu_torch.tsd.http import BadRequestError, HttpQuery


class HttpJsonSerializer:
    """Default JSON (de)serializer."""

    name = "json"

    def __init__(self, query: HttpQuery | None = None):
        self.query = query

    # -- parsers --

    def parse_put_v1(self) -> list[dict]:
        """POST /api/put body: one datapoint object or a list of them."""
        body = self.query.json_body()
        if isinstance(body, dict):
            body = [body]
        if not isinstance(body, list):
            raise BadRequestError("Unparseable data content",
                                  details="Expected a JSON object or array")
        for dp in body:
            if not isinstance(dp, dict):
                raise BadRequestError("Unparseable data content",
                                      details="Expected datapoint objects")
        return body

    def parse_query_v1(self) -> TSQuery:
        """POST /api/query body -> TSQuery (HttpJsonSerializer.parseQueryV1)."""
        return ts_query_from_json(self.query.json_body())

    # -- formatters (each returns a JSON-able object; HttpQuery renders) --

    def format_put_v1(self, results: dict) -> dict:
        return results

    def format_aggregators_v1(self, aggregators: list[str]) -> list[str]:
        return aggregators

    def format_version_v1(self, version: dict) -> dict:
        return version

    def format_query_v1(self, data_query: TSQuery,
                        results: list) -> list[dict]:
        """The /api/query result array (formatQueryAsyncV1 :516)."""
        out = []
        for r in results:
            sub = (data_query.queries[r.index]
                   if r.index < len(data_query.queries) else None)
            out.append(r.to_json(
                ms_resolution=data_query.ms_resolution,
                show_tsuids=data_query.show_tsuids,
                fill_policy=sub.fill_policy if sub is not None else "none",
                show_query=data_query.show_query,
                sub_query=sub,
                no_annotations=data_query.no_annotations,
                global_annotations=data_query.global_annotations))
        return out


def ts_query_from_json(body) -> TSQuery:
    """JSON /api/query body -> TSQuery object model."""
    if not isinstance(body, dict):
        raise BadRequestError("Unparseable data content",
                              details="Expected a JSON object")
    if "queries" not in body or not body["queries"]:
        raise BadRequestError("Missing queries")
    q = TSQuery(
        start=str(body.get("start", "")),
        end=str(body["end"]) if body.get("end") not in (None, "") else None,
        timezone=body.get("timezone"),
        ms_resolution=bool(body.get("msResolution",
                                    body.get("ms", False))),
        show_tsuids=bool(body.get("showTSUIDs", False)),
        no_annotations=bool(body.get("noAnnotations", False)),
        global_annotations=bool(body.get("globalAnnotations", False)),
        show_summary=bool(body.get("showSummary", False)),
        show_stats=bool(body.get("showStats", False)),
        show_query=bool(body.get("showQuery", False)),
        delete=bool(body.get("delete", False)),
        use_calendar=bool(body.get("useCalendar", False)),
    )
    for i, sq in enumerate(body["queries"]):
        q.queries.append(sub_query_from_json(sq, i))
    return q


def sub_query_from_json(sq: dict, index: int) -> TSSubQuery:
    if not isinstance(sq, dict):
        raise BadRequestError("Unparseable sub query")
    sub = TSSubQuery(
        aggregator=sq.get("aggregator", ""),
        metric=sq.get("metric"),
        tsuids=sq.get("tsuids"),
        downsample=sq.get("downsample"),
        rate=bool(sq.get("rate", False)),
        explicit_tags=bool(sq.get("explicitTags", False)),
        pre_aggregate=bool(sq.get("preAggregate", False)),
        rollup_usage=sq.get("rollupUsage"),
        index=index,
    )
    ro = sq.get("rateOptions")
    if ro:
        sub.rate_options = RateOptions(
            counter=bool(ro.get("counter", False)),
            counter_max=int(ro.get("counterMax", RateOptions().counter_max)),
            reset_value=int(ro.get("resetValue", 0)),
            drop_resets=bool(ro.get("dropResets", False)))
    filters = []
    for f in sq.get("filters", []) or []:
        filters.append(build_filter(
            f["tagk"], f.get("type", "literal_or"), f.get("filter", ""),
            group_by=bool(f.get("groupBy", False))))
    # legacy "tags" map (2.1-style {host: "web01"} / {host: "*"})
    tags = sq.get("tags") or {}
    if tags:
        tags_to_filters(dict(tags), filters)
    sub.filters = filters
    pct = sq.get("percentiles")
    if pct:
        sub.percentiles = [float(p) for p in pct]
    sub.show_histogram_buckets = bool(sq.get("showHistogramBuckets", False))
    return sub


SERIALIZERS = {HttpJsonSerializer.name: HttpJsonSerializer}


def serializer_for(query: HttpQuery) -> HttpJsonSerializer:
    name = query.get_query_string_param("serializer") or "json"
    cls = SERIALIZERS.get(name)
    if cls is None:
        raise BadRequestError("Could not find a serializer named: %s" % name,
                              status=400)
    return cls(query)
