"""Protobuf wire-format serializer (dependency-free).

Wire-compatible with the reference's protobuf Serializer
(encoding/proto/proto.go, message definitions internal/public.proto):
QueryRequest/QueryResponse (with the QueryResult type enum
proto.go:1046-1057), ImportRequest/ImportValueRequest,
TranslateKeysRequest/Response, and the Attr encoding (type tags
proto.go attrTypeString..Float).  The reference negotiates this format
with ``Content-Type/Accept: application/x-protobuf`` on the query and
import routes; so does this server.

Hand-rolled encoder/decoder for proto3 varint/length-delimited wire
types — no generated code, no protobuf runtime dependency.

A copy of ``pilosa_tpu/net/proto.py``: every message encodes to the same
bytes.  A decoded Row result is built on the card unless the caller names
another ``device``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from ..core.row import Row
from ..executor import FieldRow, GroupCount, RowIdentifiers, ValCount

CONTENT_TYPE = "application/x-protobuf"

# QueryResult.Type enum (encoding/proto/proto.go:1046-1057).
RESULT_NIL = 0
RESULT_ROW = 1
RESULT_PAIRS = 2
RESULT_VALCOUNT = 3
RESULT_UINT64 = 4
RESULT_BOOL = 5
RESULT_ROWIDS = 6
RESULT_GROUPCOUNTS = 7
RESULT_ROWIDENTIFIERS = 8

ATTR_STRING = 1
ATTR_INT = 2
ATTR_BOOL = 3
ATTR_FLOAT = 4


# -- primitive wire encoding ------------------------------------------------

def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _tag(field: int, wire: int) -> bytes:
    return _uvarint((field << 3) | wire)


def _varint_field(field: int, v: int) -> bytes:
    # proto3 int64/uint64/bool/enum: two's-complement varint (not zigzag).
    if v < 0:
        v &= 0xFFFFFFFFFFFFFFFF
    return _tag(field, 0) + _uvarint(v)


def _len_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _uvarint(len(data)) + data


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def _packed_uint64(field: int, values) -> bytes:
    if not values:
        return b""
    body = b"".join(_uvarint(int(v)) for v in values)
    return _len_field(field, body)


def _packed_int64(field: int, values) -> bytes:
    if not values:
        return b""
    body = b"".join(
        _uvarint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values
    )
    return _len_field(field, body)


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def uvarint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def svarint(self) -> int:
        v = self.uvarint()
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def tag(self) -> Tuple[int, int]:
        t = self.uvarint()
        return t >> 3, t & 7

    def bytes_(self) -> memoryview:
        n = self.uvarint()
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def str_(self) -> str:
        return bytes(self.bytes_()).decode()

    def skip(self, wire: int):
        if wire == 0:
            self.uvarint()
        elif wire == 1:
            self.pos += 8
        elif wire == 2:
            self.pos += self.uvarint()
        elif wire == 5:
            self.pos += 4
        else:
            raise ValueError(f"bad wire type {wire}")


def _read_packed_uint64(r: _Reader, wire: int) -> List[int]:
    if wire == 2:
        sub = _Reader(r.bytes_())
        out = []
        while not sub.eof():
            out.append(sub.uvarint())
        return out
    return [r.uvarint()]


# -- attrs (internal Attr; proto.go encodeAttrs) -----------------------------

def encode_attrs(attrs: Dict[str, object]) -> List[bytes]:
    out = []
    for k in sorted(attrs):
        v = attrs[k]
        body = _str_field(1, k)
        if isinstance(v, bool):
            body += _varint_field(2, ATTR_BOOL) + _varint_field(5, 1 if v else 0)
        elif isinstance(v, int):
            body += _varint_field(2, ATTR_INT) + _varint_field(4, v)
        elif isinstance(v, float):
            body += _varint_field(2, ATTR_FLOAT) + _double_field(6, v)
        else:
            body += _varint_field(2, ATTR_STRING) + _str_field(3, str(v))
        out.append(body)
    return out


def decode_attr(data) -> Tuple[str, object]:
    r = _Reader(data)
    key, typ = "", 0
    sval, ival, bval, fval = "", 0, False, 0.0
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            key = r.str_()
        elif f == 2:
            typ = r.uvarint()
        elif f == 3:
            sval = r.str_()
        elif f == 4:
            ival = r.svarint()
        elif f == 5:
            bval = bool(r.uvarint())
        elif f == 6:
            fval = struct.unpack("<d", bytes(r.data[r.pos : r.pos + 8]))[0]
            r.pos += 8
        else:
            r.skip(w)
    value = {ATTR_STRING: sval, ATTR_INT: ival, ATTR_BOOL: bval, ATTR_FLOAT: fval}[
        typ
    ]
    return key, value


def decode_attrs(parts: List) -> Dict[str, object]:
    return dict(decode_attr(p) for p in parts)


# -- QueryRequest ------------------------------------------------------------

def encode_query_request(
    query: str,
    shards=None,
    column_attrs=False,
    remote=False,
    exclude_row_attrs=False,
    exclude_columns=False,
) -> bytes:
    out = _str_field(1, query)
    out += _packed_uint64(2, shards or [])
    if column_attrs:
        out += _varint_field(3, 1)
    if remote:
        out += _varint_field(5, 1)
    if exclude_row_attrs:
        out += _varint_field(6, 1)
    if exclude_columns:
        out += _varint_field(7, 1)
    return out


def decode_query_request(data) -> dict:
    r = _Reader(data)
    out = {
        "query": "",
        "shards": [],
        "columnAttrs": False,
        "remote": False,
        "excludeRowAttrs": False,
        "excludeColumns": False,
    }
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            out["query"] = r.str_()
        elif f == 2:
            out["shards"].extend(_read_packed_uint64(r, w))
        elif f == 3:
            out["columnAttrs"] = bool(r.uvarint())
        elif f == 5:
            out["remote"] = bool(r.uvarint())
        elif f == 6:
            out["excludeRowAttrs"] = bool(r.uvarint())
        elif f == 7:
            out["excludeColumns"] = bool(r.uvarint())
        else:
            r.skip(w)
    if not out["shards"]:
        out["shards"] = None
    return out


# -- results -----------------------------------------------------------------

def _encode_row(row: Row) -> bytes:
    out = b""
    if row.keys is not None:
        for k in row.keys:
            out += _str_field(3, k)
    else:
        out += _packed_uint64(1, [int(c) for c in row.columns()])
    for a in encode_attrs(row.attrs or {}):
        out += _len_field(2, a)
    return out


def _decode_row(data, device=None) -> Row:
    r = _Reader(data)
    columns: List[int] = []
    keys: List[str] = []
    attr_parts = []
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            columns.extend(_read_packed_uint64(r, w))
        elif f == 2:
            attr_parts.append(r.bytes_())
        elif f == 3:
            keys.append(r.str_())
        else:
            r.skip(w)
    row = Row.from_columns(columns, device=device)
    if keys:
        row.keys = keys
    attrs = decode_attrs(attr_parts)
    if attrs:
        row.attrs = attrs
    return row


def encode_result(result) -> bytes:
    """One QueryResult message (proto.go encodeQueryResult :410-445)."""
    out = b""
    if result is None:
        typ = RESULT_NIL
    elif isinstance(result, Row):
        typ = RESULT_ROW
        out += _len_field(1, _encode_row(result))
    elif isinstance(result, bool):
        typ = RESULT_BOOL
        out += _varint_field(4, 1 if result else 0)
    elif isinstance(result, int):
        typ = RESULT_UINT64
        out += _varint_field(2, result)
    elif isinstance(result, ValCount):
        typ = RESULT_VALCOUNT
        body = _varint_field(1, result.val) + _varint_field(2, result.count)
        out += _len_field(5, body)
    elif isinstance(result, RowIdentifiers):
        typ = RESULT_ROWIDENTIFIERS
        body = _packed_uint64(1, result.rows)
        for k in result.keys:
            body += _str_field(2, k)
        out += _len_field(9, body)
    elif isinstance(result, list) and result and isinstance(result[0], GroupCount):
        typ = RESULT_GROUPCOUNTS
        for gc in result:
            body = b""
            for fr in gc.group:
                frb = _str_field(1, fr.field) + _varint_field(2, fr.row_id)
                body += _len_field(1, frb)
            body += _varint_field(2, gc.count)
            out += _len_field(8, body)
    elif isinstance(result, list) and result and isinstance(result[0], tuple):
        typ = RESULT_PAIRS
        for id_or_key, count in result:
            if isinstance(id_or_key, str):
                body = _str_field(3, id_or_key)
            else:
                body = _varint_field(1, id_or_key)
            body += _varint_field(2, count)
            out += _len_field(3, body)
    elif isinstance(result, list):
        typ = RESULT_ROWIDS
        out += _packed_uint64(7, result)
    else:
        typ = RESULT_NIL
    return _varint_field(6, typ) + out


def decode_result(data, device=None):
    r = _Reader(data)
    typ = RESULT_NIL
    row = None
    n = 0
    changed = False
    pairs = []
    valcount = None
    row_ids: List[int] = []
    group_counts = []
    row_identifiers = None
    while not r.eof():
        f, w = r.tag()
        if f == 6:
            typ = r.uvarint()
        elif f == 1:
            row = _decode_row(r.bytes_(), device)
        elif f == 2:
            n = r.uvarint()
        elif f == 3:
            pairs.append(_decode_pair(r.bytes_()))
        elif f == 4:
            changed = bool(r.uvarint())
        elif f == 5:
            valcount = _decode_valcount(r.bytes_())
        elif f == 7:
            row_ids.extend(_read_packed_uint64(r, w))
        elif f == 8:
            group_counts.append(_decode_group_count(r.bytes_()))
        elif f == 9:
            row_identifiers = _decode_row_identifiers(r.bytes_())
        else:
            r.skip(w)
    return {
        RESULT_NIL: None,
        RESULT_ROW: row,
        RESULT_PAIRS: pairs,
        RESULT_VALCOUNT: valcount,
        RESULT_UINT64: n,
        RESULT_BOOL: changed,
        RESULT_ROWIDS: row_ids,
        RESULT_GROUPCOUNTS: group_counts,
        RESULT_ROWIDENTIFIERS: row_identifiers,
    }[typ]


def _decode_pair(data) -> tuple:
    r = _Reader(data)
    id, key, count = 0, "", 0
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            id = r.uvarint()
        elif f == 2:
            count = r.uvarint()
        elif f == 3:
            key = r.str_()
        else:
            r.skip(w)
    return (key if key else id, count)


def _decode_valcount(data) -> ValCount:
    r = _Reader(data)
    val = count = 0
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            val = r.svarint()
        elif f == 2:
            count = r.svarint()
        else:
            r.skip(w)
    return ValCount(val, count)


def _decode_group_count(data) -> GroupCount:
    r = _Reader(data)
    group = []
    count = 0
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            sub = _Reader(r.bytes_())
            field, row_id = "", 0
            while not sub.eof():
                sf, sw = sub.tag()
                if sf == 1:
                    field = sub.str_()
                elif sf == 2:
                    row_id = sub.uvarint()
                else:
                    sub.skip(sw)
            group.append(FieldRow(field, row_id))
        elif f == 2:
            count = r.uvarint()
        else:
            r.skip(w)
    return GroupCount(group, count)


def _decode_row_identifiers(data) -> RowIdentifiers:
    r = _Reader(data)
    rows: List[int] = []
    keys: List[str] = []
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            rows.extend(_read_packed_uint64(r, w))
        elif f == 2:
            keys.append(r.str_())
        else:
            r.skip(w)
    return RowIdentifiers(rows, keys)


def encode_query_response(resp, err: str = "") -> bytes:
    out = b""
    if err:
        out += _str_field(1, err)
    for result in resp.results:
        out += _len_field(2, encode_result(result))
    for cas in resp.column_attr_sets or []:
        body = b""
        if cas.key:
            body += _str_field(3, cas.key)
        else:
            body += _varint_field(1, cas.id)
        for a in encode_attrs(cas.attrs):
            body += _len_field(2, a)
        out += _len_field(3, body)
    return out


def decode_query_response(data, device=None) -> dict:
    r = _Reader(data)
    out = {"err": "", "results": [], "columnAttrs": []}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            out["err"] = r.str_()
        elif f == 2:
            out["results"].append(decode_result(r.bytes_(), device))
        elif f == 3:
            sub = _Reader(r.bytes_())
            cas = {"id": 0, "key": "", "attrs": {}}
            attr_parts = []
            while not sub.eof():
                sf, sw = sub.tag()
                if sf == 1:
                    cas["id"] = sub.uvarint()
                elif sf == 2:
                    attr_parts.append(sub.bytes_())
                elif sf == 3:
                    cas["key"] = sub.str_()
                else:
                    sub.skip(sw)
            cas["attrs"] = decode_attrs(attr_parts)
            out["columnAttrs"].append(cas)
        else:
            r.skip(w)
    return out


# -- imports -----------------------------------------------------------------

def encode_import_request(
    index, field, shard=0, row_ids=None, column_ids=None, row_keys=None,
    column_keys=None, timestamps=None,
) -> bytes:
    out = _str_field(1, index) + _str_field(2, field) + _varint_field(3, shard)
    out += _packed_uint64(4, row_ids or [])
    out += _packed_uint64(5, column_ids or [])
    out += _packed_int64(6, timestamps or [])
    for k in row_keys or []:
        out += _str_field(7, k)
    for k in column_keys or []:
        out += _str_field(8, k)
    return out


def decode_import_request(data) -> dict:
    r = _Reader(data)
    out = {
        "index": "",
        "field": "",
        "shard": 0,
        "rowIDs": [],
        "columnIDs": [],
        "timestamps": [],
        "rowKeys": [],
        "columnKeys": [],
    }
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            out["index"] = r.str_()
        elif f == 2:
            out["field"] = r.str_()
        elif f == 3:
            out["shard"] = r.uvarint()
        elif f == 4:
            out["rowIDs"].extend(_read_packed_uint64(r, w))
        elif f == 5:
            out["columnIDs"].extend(_read_packed_uint64(r, w))
        elif f == 6:
            out["timestamps"].extend(
                v - (1 << 64) if v >= 1 << 63 else v
                for v in _read_packed_uint64(r, w)
            )
        elif f == 7:
            out["rowKeys"].append(r.str_())
        elif f == 8:
            out["columnKeys"].append(r.str_())
        else:
            r.skip(w)
    return out


def encode_import_value_request(
    index, field, shard=0, column_ids=None, column_keys=None, values=None
) -> bytes:
    out = _str_field(1, index) + _str_field(2, field) + _varint_field(3, shard)
    out += _packed_uint64(5, column_ids or [])
    out += _packed_int64(6, values or [])
    for k in column_keys or []:
        out += _str_field(7, k)
    return out


def decode_import_value_request(data) -> dict:
    r = _Reader(data)
    out = {"index": "", "field": "", "shard": 0, "columnIDs": [], "values": [], "columnKeys": []}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            out["index"] = r.str_()
        elif f == 2:
            out["field"] = r.str_()
        elif f == 3:
            out["shard"] = r.uvarint()
        elif f == 5:
            out["columnIDs"].extend(_read_packed_uint64(r, w))
        elif f == 6:
            out["values"].extend(
                v - (1 << 64) if v >= 1 << 63 else v
                for v in _read_packed_uint64(r, w)
            )
        elif f == 7:
            out["columnKeys"].append(r.str_())
        else:
            r.skip(w)
    return out
