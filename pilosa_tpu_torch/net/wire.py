"""Wire serialization of query results.

JSON shapes mirror the reference's MarshalJSON implementations
(http/handler.go QueryResponse :30-77, row.go, executor.go FieldRow
:982-1001): Row -> {attrs, columns|keys}, ValCount -> {value, count},
TopN pairs -> [{id|key, count}], Rows -> {rows|keys}, GroupBy ->
[{group, count}].

A copy of ``pilosa_tpu/net/wire.py``: the same results encode to the same
bytes.  ``result_from_json`` builds a Row on the card unless the caller
names another ``device``.
"""

from __future__ import annotations

from ..core.row import Row
from ..executor import FieldRow, GroupCount, RowIdentifiers, ValCount
from .front import fast_results_bytes  # noqa: F401 — re-exported


def result_to_json(result):
    if result is None:
        return None
    if isinstance(result, Row):
        out = {"attrs": result.attrs or {}}
        if result.keys is not None:
            out["keys"] = result.keys
        else:
            out["columns"] = [int(c) for c in result.columns()]
        return out
    if isinstance(result, bool):
        return result
    if isinstance(result, int):
        return result
    if isinstance(result, ValCount):
        return result.to_dict()
    if isinstance(result, RowIdentifiers):
        return result.to_dict()
    if isinstance(result, list):
        if result and isinstance(result[0], tuple):
            # TopN pairs: (id_or_key, count)
            return [
                {("key" if isinstance(i, str) else "id"): i, "count": c}
                for i, c in result
            ]
        if result and isinstance(result[0], GroupCount):
            return [g.to_dict() for g in result]
        return result
    return result


def response_to_json(resp) -> dict:
    out = {"results": [result_to_json(r) for r in resp.results]}
    if resp.column_attr_sets is not None:
        out["columnAttrs"] = [c.to_dict() for c in resp.column_attr_sets]
    return out


def fast_result_values(resp):
    """The response's results as fast-encodable plain values, or None.

    A result qualifies when it is a plain int (the batched Count tier)
    or a TopN ``(id, count)`` pair list with integer ids — the classic
    dashboard payload, which previously always took the generic
    ``result_to_json`` walk.  Keyed TopN (string ids), Rows, ValCount,
    bools, and attr-carrying responses disqualify (``None``): callers
    fall back to the generic encoder.  The returned structure is also
    what the process-mode RESULT_FAST frame carries (net/ipc.py), so
    the device-owner ships values and the worker does the JSON encode.
    """
    if resp.column_attr_sets is not None:
        return None
    results = resp.results
    out = []
    for r in results:
        if type(r) is int:
            out.append(r)
        elif type(r) is list:
            for pair in r:
                if (
                    type(pair) is not tuple
                    or len(pair) != 2
                    or type(pair[0]) is not int
                    or type(pair[1]) is not int
                ):
                    return None
            out.append(r)
        else:
            return None
    return out


def count_response_bytes(resp, trace_id=None):
    """Fast-path JSON encoding for int / TopN-pair responses: builds
    the exact bytes ``json.dumps`` would produce for
    ``{"results": [...], "traceID": ...}`` without the generic
    ``result_to_json`` walk — at 10k+ responses/second the per-response
    dict build + dispatch chain is measurable host work on the collect
    path.  Returns None when any result doesn't qualify (bool is not an
    int here: it serializes as true/false) or the response carries
    column attributes — callers fall back to the generic encoder."""
    results = fast_result_values(resp)
    if results is None:
        return None
    return fast_results_bytes(results, trace_id)


def result_from_json(call_name: str, doc, device=None):
    """Decode a remote node's partial result back into executor types
    (the JSON analogue of encoding/proto's QueryResponse decode used by
    remoteExec, executor.go:2142-2158)."""
    if doc is None:
        return None
    if isinstance(doc, bool):
        return doc
    if isinstance(doc, (int, float)):
        return int(doc)
    if isinstance(doc, dict):
        if "columns" in doc or ("attrs" in doc and "keys" not in doc):
            row = Row.from_columns(doc.get("columns", []), device=device)
            row.attrs = doc.get("attrs") or None
            return row
        if "value" in doc and "count" in doc:
            return ValCount(doc["value"], doc["count"])
        if "rows" in doc or "keys" in doc:
            return RowIdentifiers(doc.get("rows", []), doc.get("keys"))
    if isinstance(doc, list):
        if not doc:
            return [] if call_name in ("TopN", "Rows", "GroupBy") else doc
        first = doc[0]
        if isinstance(first, dict) and "count" in first and "id" in first:
            return [(d["id"], d["count"]) for d in doc]
        if isinstance(first, dict) and "count" in first and "key" in first:
            return [(d["key"], d["count"]) for d in doc]
        if isinstance(first, dict) and "group" in first:
            return [
                GroupCount(
                    [
                        FieldRow(
                            g["field"], g.get("rowID", 0), g.get("rowKey", "")
                        )
                        for g in d["group"]
                    ],
                    d["count"],
                )
                for d in doc
            ]
        return [int(x) for x in doc]
    return doc
