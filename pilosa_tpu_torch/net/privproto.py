"""Cluster control-plane wire format: [1-byte type][protobuf].

Mirror of the reference's internal message framing (broadcast.go
MarshalInternalMessage :75-83, type table :55-73) with message bodies
matching ``internal/private.proto`` field numbers, hand-rolled over the
same proto3 primitives as net/proto.py (public.proto).

Extension fields: this framework's schema-sync hardening carries object
creation ids and delete tombstones that the reference's messages do not
have.  They ride in field numbers >= 100 of the corresponding messages —
proto3 decoders (including the reference's) skip unknown fields, so the
standard part of every message stays byte-compatible while peers of THIS
framework get the extra convergence data.

Codec boundary only: handlers keep consuming the same dicts
(api.cluster_message); this module converts dict <-> wire at the
transport seam (HTTP /internal/cluster/message bodies and gossip
broadcast payloads).

A copy of ``pilosa_tpu/net/privproto.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .proto import (
    _len_field,
    _packed_uint64,
    _Reader,
    _read_packed_uint64,
    _str_field as _str_field_always,
    _varint_field as _varint_field_always,
)


def _str_field(field: int, s: str) -> bytes:
    """proto3 canonical: default (empty) values are OMITTED — decoders
    must not materialize explicit empties a dict consumer would treat
    differently from an absent key."""
    return _str_field_always(field, s) if s else b""


def _varint_field(field: int, v: int) -> bytes:
    return _varint_field_always(field, v) if v else b""

# broadcast.go:55-73 message type bytes.
MSG_CREATE_SHARD = 0
MSG_CREATE_INDEX = 1
MSG_DELETE_INDEX = 2
MSG_CREATE_FIELD = 3
MSG_DELETE_FIELD = 4
MSG_CREATE_VIEW = 5
MSG_DELETE_VIEW = 6
MSG_CLUSTER_STATUS = 7
MSG_RESIZE_INSTRUCTION = 8
MSG_RESIZE_COMPLETE = 9
MSG_SET_COORDINATOR = 10
MSG_UPDATE_COORDINATOR = 11
MSG_NODE_STATE = 12
MSG_RECALCULATE_CACHES = 13
MSG_NODE_EVENT = 14
MSG_NODE_STATUS = 15

# Our json "type" string <-> wire type byte.
_TYPE_BYTES = {
    "create-shard": MSG_CREATE_SHARD,
    "create-index": MSG_CREATE_INDEX,
    "delete-index": MSG_DELETE_INDEX,
    "create-field": MSG_CREATE_FIELD,
    "delete-field": MSG_DELETE_FIELD,
    "create-view": MSG_CREATE_VIEW,
    "delete-view": MSG_DELETE_VIEW,
    "set-state": MSG_CLUSTER_STATUS,
    "resize-instruction": MSG_RESIZE_INSTRUCTION,
    "resize-complete": MSG_RESIZE_COMPLETE,
    "set-coordinator": MSG_SET_COORDINATOR,
    "update-coordinator": MSG_UPDATE_COORDINATOR,
    "node-state": MSG_NODE_STATE,
    "recalculate-caches": MSG_RECALCULATE_CACHES,
    "node-event": MSG_NODE_EVENT,
    "node-status": MSG_NODE_STATUS,
}
_TYPE_NAMES = {v: k for k, v in _TYPE_BYTES.items()}


def _bool_field(field: int, v: bool) -> bytes:
    return _varint_field(field, 1) if v else b""


def _sint_field(field: int, v: int) -> bytes:
    """int64 proto field (plain varint, two's complement for negatives)."""
    if v == 0:
        return b""
    return _varint_field(field, v & 0xFFFFFFFFFFFFFFFF)


def _to_int64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# -- FieldOptions (private.proto:10-19) ------------------------------------


def _encode_field_options(meta: dict) -> bytes:
    out = b""
    out += _str_field(3, meta.get("cacheType", ""))
    out += _varint_field(4, int(meta.get("cacheSize", 0)))
    out += _str_field(5, meta.get("timeQuantum", ""))
    out += _str_field(8, meta.get("type", ""))
    out += _sint_field(9, int(meta.get("min", 0)))
    out += _sint_field(10, int(meta.get("max", 0)))
    out += _bool_field(11, bool(meta.get("keys", False)))
    out += _bool_field(12, bool(meta.get("noStandardView", False)))
    return out


def _decode_field_options(data) -> dict:
    r = _Reader(data)
    meta: dict = {}
    while not r.eof():
        f, w = r.tag()
        if f == 3:
            meta["cacheType"] = r.str_()
        elif f == 4:
            meta["cacheSize"] = r.uvarint()
        elif f == 5:
            meta["timeQuantum"] = r.str_()
        elif f == 8:
            meta["type"] = r.str_()
        elif f == 9:
            meta["min"] = _to_int64(r.uvarint())
        elif f == 10:
            meta["max"] = _to_int64(r.uvarint())
        elif f == 11:
            meta["keys"] = bool(r.uvarint())
        elif f == 12:
            meta["noStandardView"] = bool(r.uvarint())
        else:
            r.skip(w)
    return meta


# -- URI / Node (private.proto:93-104) -------------------------------------


def _encode_uri(uri: str) -> bytes:
    scheme, _, rest = uri.partition("://")
    if not rest:
        scheme, rest = "http", uri
    host, _, port = rest.rpartition(":")
    if not host:
        host, port = rest, "0"
    out = _str_field(1, scheme)
    out += _str_field(2, host)
    out += _varint_field(3, int(port or 0))
    return out


def _decode_uri(data) -> str:
    r = _Reader(data)
    scheme, host, port = "http", "", 0
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            scheme = r.str_()
        elif f == 2:
            host = r.str_()
        elif f == 3:
            port = r.uvarint()
        else:
            r.skip(w)
    return f"{scheme}://{host}:{port}" if port else f"{scheme}://{host}"


def _encode_node(node: dict) -> bytes:
    out = _str_field(1, node.get("id", ""))
    uri = node.get("uri", "")
    if uri:
        out += _len_field(2, _encode_uri(uri))
    out += _bool_field(3, bool(node.get("isCoordinator", False)))
    out += _str_field(4, node.get("state", ""))
    return out


def _decode_node(data) -> dict:
    r = _Reader(data)
    node: dict = {}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            node["id"] = r.str_()
        elif f == 2:
            node["uri"] = _decode_uri(r.bytes_())
        elif f == 3:
            node["isCoordinator"] = bool(r.uvarint())
        elif f == 4:
            node["state"] = r.str_()
        else:
            r.skip(w)
    return node


# -- per-type bodies --------------------------------------------------------


def _encode_create_shard(msg: dict) -> bytes:
    return (
        _str_field(1, msg.get("index", ""))
        + _varint_field(2, int(msg.get("shard", 0)))
        + _str_field(3, msg.get("field", ""))
    )


def _decode_create_shard(r: _Reader) -> dict:
    msg = {"index": "", "field": "", "shard": 0}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 2:
            msg["shard"] = r.uvarint()
        elif f == 3:
            msg["field"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_create_index(msg: dict) -> bytes:
    meta = msg.get("meta", {})
    meta_b = _bool_field(3, bool(meta.get("keys", False))) + _bool_field(
        4, bool(meta.get("trackExistence", True))
    )
    out = _str_field(1, msg.get("index", ""))
    out += _len_field(2, meta_b)
    out += _str_field(100, msg.get("cid", ""))
    return out


def _decode_create_index(r: _Reader) -> dict:
    msg: dict = {"index": "", "meta": {}}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 2:
            mr = _Reader(r.bytes_())
            while not mr.eof():
                mf, mw = mr.tag()
                if mf == 3:
                    msg["meta"]["keys"] = bool(mr.uvarint())
                elif mf == 4:
                    msg["meta"]["trackExistence"] = bool(mr.uvarint())
                else:
                    mr.skip(mw)
        elif f == 100:
            msg["cid"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_delete_index(msg: dict) -> bytes:
    out = _str_field(1, msg.get("index", ""))
    out += _str_field(100, msg.get("cid", ""))
    for fcid in msg.get("fieldCids", []):
        out += _str_field(101, fcid)
    return out


def _decode_delete_index(r: _Reader) -> dict:
    msg: dict = {"index": "", "fieldCids": []}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 100:
            msg["cid"] = r.str_()
        elif f == 101:
            msg["fieldCids"].append(r.str_())
        else:
            r.skip(w)
    return msg


def _encode_create_field(msg: dict) -> bytes:
    out = _str_field(1, msg.get("index", ""))
    out += _str_field(2, msg.get("field", ""))
    out += _len_field(3, _encode_field_options(msg.get("meta", {})))
    out += _str_field(100, msg.get("cid", ""))
    return out


def _decode_create_field(r: _Reader) -> dict:
    msg: dict = {"index": "", "field": "", "meta": {}}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 2:
            msg["field"] = r.str_()
        elif f == 3:
            msg["meta"] = _decode_field_options(r.bytes_())
        elif f == 100:
            msg["cid"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_delete_field(msg: dict) -> bytes:
    return (
        _str_field(1, msg.get("index", ""))
        + _str_field(2, msg.get("field", ""))
        + _str_field(100, msg.get("cid", ""))
    )


def _decode_delete_field(r: _Reader) -> dict:
    msg: dict = {"index": "", "field": ""}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 2:
            msg["field"] = r.str_()
        elif f == 100:
            msg["cid"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_view_msg(msg: dict) -> bytes:
    return (
        _str_field(1, msg.get("index", ""))
        + _str_field(2, msg.get("field", ""))
        + _str_field(3, msg.get("view", ""))
    )


def _decode_view_msg(r: _Reader) -> dict:
    msg = {"index": "", "field": "", "view": ""}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["index"] = r.str_()
        elif f == 2:
            msg["field"] = r.str_()
        elif f == 3:
            msg["view"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_cluster_status(msg: dict) -> bytes:
    out = _str_field(1, msg.get("clusterId", ""))
    out += _str_field(2, msg.get("state", ""))
    for node in msg.get("nodes", []):
        out += _len_field(3, _encode_node(node))
    return out


def _decode_cluster_status(r: _Reader) -> dict:
    msg: dict = {"state": "", "nodes": []}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["clusterId"] = r.str_()
        elif f == 2:
            msg["state"] = r.str_()
        elif f == 3:
            msg["nodes"].append(_decode_node(r.bytes_()))
        else:
            r.skip(w)
    return msg


def _encode_resize_instruction(msg: dict) -> bytes:
    out = _sint_field(1, int(msg.get("jobId", 0)))
    # Target node (field 2) and coordinator (field 3) identity, as the
    # reference's ResizeInstruction carries (private.proto); Schema (5)
    # and ClusterStatus (6) are NOT emitted — handlers here converge
    # schema via the NodeStatus exchange instead (see module docstring).
    if msg.get("node"):
        out += _len_field(2, _encode_node(msg["node"]))
    if msg.get("coordinator"):
        out += _len_field(3, _encode_node(msg["coordinator"]))
    for s in msg.get("sources", []):
        src = b""
        if s.get("uri"):
            src += _len_field(1, _encode_node({"uri": s["uri"]}))
        src += _str_field(2, s.get("index", ""))
        src += _str_field(3, s.get("field", ""))
        src += _str_field(4, s.get("view", ""))
        src += _varint_field(5, int(s.get("shard", 0)))
        out += _len_field(4, src)
    return out


def _decode_resize_instruction(r: _Reader) -> dict:
    msg: dict = {"jobId": 0, "sources": []}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["jobId"] = _to_int64(r.uvarint())
        elif f == 2:
            msg["node"] = _decode_node(r.bytes_())
        elif f == 3:
            msg["coordinator"] = _decode_node(r.bytes_())
        elif f == 4:
            sr = _Reader(r.bytes_())
            src = {"uri": "", "index": "", "field": "", "view": "", "shard": 0}
            while not sr.eof():
                sf, sw = sr.tag()
                if sf == 1:
                    src["uri"] = _decode_node(sr.bytes_()).get("uri", "")
                elif sf == 2:
                    src["index"] = sr.str_()
                elif sf == 3:
                    src["field"] = sr.str_()
                elif sf == 4:
                    src["view"] = sr.str_()
                elif sf == 5:
                    src["shard"] = sr.uvarint()
                else:
                    sr.skip(sw)
            msg["sources"].append(src)
        else:
            r.skip(w)
    return msg


def _encode_node_status(msg: dict) -> bytes:
    """NodeStatus (private.proto:116-130): sender Node at field 1, Schema
    carries names + options + view names (+ our cids at 101),
    IndexStatus/FieldStatus carry availableShards; tombstones are
    extension field 100."""
    schema_b = b""
    statuses = b""
    for iname, info in msg.get("indexes", {}).items():
        idx_b = _str_field(1, iname)
        # Index meta (keys) is not in the reference's Schema.Index;
        # extension field 100 (IndexMeta) + 101 (cid).
        idx_b += _len_field(100, _bool_field(3, bool(info.get("keys", False))))
        idx_b += _str_field(101, info.get("cid", ""))
        st_b = _str_field(1, iname)
        for fname, finfo in info.get("fields", {}).items():
            f_b = _str_field(1, fname)
            f_b += _len_field(2, _encode_field_options(finfo.get("options", {})))
            for vname in finfo.get("views", []):
                f_b += _str_field_always(3, vname)
            f_b += _str_field(101, finfo.get("cid", ""))
            idx_b += _len_field(4, f_b)
            fs_b = _str_field(1, fname)
            fs_b += _packed_uint64(2, finfo.get("availableShards", []))
            st_b += _len_field(2, fs_b)
        schema_b += _len_field(1, idx_b)
        statuses += _len_field(4, st_b)
    out = b""
    if msg.get("node"):
        out += _len_field(1, _encode_node(msg["node"]))
    out += _len_field(3, schema_b) + statuses
    for t in msg.get("tombstones", []):
        out += _str_field(100, t)
    # Extension 102: the sender's cluster-state string (the RESIZING
    # adoption check, api.cluster_message); 103: per-index data-version
    # tokens — the heartbeat payload bounded replica reads consult;
    # 104: the sender's completed anti-entropy pass counter (the
    # bounded-read quarantine release signal, docs/durability.md).
    out += _str_field(102, msg.get("state", ""))
    for iname, v in (msg.get("versions") or {}).items():
        out += _len_field(
            103, _str_field(1, iname) + _varint_field(2, int(v))
        )
    out += _varint_field(104, int(msg.get("aePasses", 0)))
    # 105: pending-hint advertisement entries ({target node id: count},
    # hinted handoff); 106: presence marker so a receiver can tell "no
    # pending hints" (empty map — clears the previous advertisement)
    # from "sender predates hinted handoff" (field absent — leave the
    # previous advertisement untouched).
    ph = msg.get("pendingHints")
    if ph is not None:
        out += _varint_field(106, 1)
        for target, count in ph.items():
            out += _len_field(
                105, _str_field(1, str(target)) + _varint_field(2, int(count))
            )
    return out


def _decode_node_status(r: _Reader) -> dict:
    msg: dict = {"indexes": {}, "tombstones": [], "versions": {},
                 "aePasses": 0}
    shards_by_index: Dict[str, Dict[str, List[int]]] = {}
    while not r.eof():
        f, w = r.tag()
        if f == 1:  # sender Node
            msg["node"] = _decode_node(r.bytes_())
        elif f == 3:  # Schema
            sr = _Reader(r.bytes_())
            while not sr.eof():
                sf, sw = sr.tag()
                if sf != 1:
                    sr.skip(sw)
                    continue
                ir = _Reader(sr.bytes_())
                info: dict = {"keys": False, "cid": "", "fields": {}}
                iname = ""
                while not ir.eof():
                    if_, iw = ir.tag()
                    if if_ == 1:
                        iname = ir.str_()
                    elif if_ == 4:
                        fr = _Reader(ir.bytes_())
                        fname, finfo = "", {"options": {}, "cid": "", "availableShards": []}
                        while not fr.eof():
                            ff, fw = fr.tag()
                            if ff == 1:
                                fname = fr.str_()
                            elif ff == 2:
                                finfo["options"] = _decode_field_options(fr.bytes_())
                            elif ff == 3:
                                finfo.setdefault("views", []).append(fr.str_())
                            elif ff == 101:
                                finfo["cid"] = fr.str_()
                            else:
                                fr.skip(fw)
                        if fname:
                            info["fields"][fname] = finfo
                    elif if_ == 100:
                        mr = _Reader(ir.bytes_())
                        while not mr.eof():
                            mf, mw = mr.tag()
                            if mf == 3:
                                info["keys"] = bool(mr.uvarint())
                            else:
                                mr.skip(mw)
                    elif if_ == 101:
                        info["cid"] = ir.str_()
                    else:
                        ir.skip(iw)
                if iname:
                    msg["indexes"][iname] = info
        elif f == 4:  # IndexStatus
            ir = _Reader(r.bytes_())
            iname = ""
            fields: Dict[str, List[int]] = {}
            while not ir.eof():
                if_, iw = ir.tag()
                if if_ == 1:
                    iname = ir.str_()
                elif if_ == 2:
                    fr = _Reader(ir.bytes_())
                    fname, shards = "", []
                    while not fr.eof():
                        ff, fw = fr.tag()
                        if ff == 1:
                            fname = fr.str_()
                        elif ff == 2:
                            shards = _read_packed_uint64(fr, fw)
                        else:
                            fr.skip(fw)
                    if fname:
                        fields[fname] = shards
                else:
                    ir.skip(iw)
            if iname:
                shards_by_index[iname] = fields
        elif f == 100:
            msg["tombstones"].append(r.str_())
        elif f == 102:
            msg["state"] = r.str_()
        elif f == 103:
            vr = _Reader(r.bytes_())
            vname, vval = "", 0
            while not vr.eof():
                vf, vw = vr.tag()
                if vf == 1:
                    vname = vr.str_()
                elif vf == 2:
                    vval = vr.uvarint()
                else:
                    vr.skip(vw)
            if vname:
                msg["versions"][vname] = vval
        elif f == 104:
            msg["aePasses"] = r.uvarint()
        elif f == 105:
            hr = _Reader(r.bytes_())
            hname, hval = "", 0
            while not hr.eof():
                hf, hw = hr.tag()
                if hf == 1:
                    hname = hr.str_()
                elif hf == 2:
                    hval = hr.uvarint()
                else:
                    hr.skip(hw)
            if hname:
                if msg.get("pendingHints") is None:
                    msg["pendingHints"] = {}
                msg["pendingHints"][hname] = hval
        elif f == 106:
            if r.uvarint() and msg.get("pendingHints") is None:
                msg["pendingHints"] = {}
        else:
            r.skip(w)
    for iname, fields in shards_by_index.items():
        info = msg["indexes"].setdefault(
            iname, {"keys": False, "cid": "", "fields": {}}
        )
        for fname, shards in fields.items():
            finfo = info["fields"].setdefault(
                fname, {"options": {}, "cid": "", "availableShards": []}
            )
            finfo["availableShards"] = shards
    return msg


def _encode_node_state(msg: dict) -> bytes:
    return _str_field(1, msg.get("nodeId", "")) + _str_field(
        2, msg.get("state", "")
    )


def _decode_node_state(r: _Reader) -> dict:
    msg = {"nodeId": "", "state": ""}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["nodeId"] = r.str_()
        elif f == 2:
            msg["state"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_coordinator(msg: dict) -> bytes:
    return _len_field(1, _encode_node(msg.get("new", {})))


def _decode_coordinator(r: _Reader) -> dict:
    msg: dict = {"new": {}}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["new"] = _decode_node(r.bytes_())
        else:
            r.skip(w)
    return msg


def _encode_resize_complete(msg: dict) -> bytes:
    out = _sint_field(1, int(msg.get("jobId", 0)))
    if msg.get("node"):
        out += _len_field(2, _encode_node(msg["node"]))
    out += _str_field(3, msg.get("error", ""))
    return out


def _decode_resize_complete(r: _Reader) -> dict:
    msg: dict = {"jobId": 0, "error": ""}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["jobId"] = _to_int64(r.uvarint())
        elif f == 2:
            msg["node"] = _decode_node(r.bytes_())
        elif f == 3:
            msg["error"] = r.str_()
        else:
            r.skip(w)
    return msg


def _encode_node_event(msg: dict) -> bytes:
    out = _varint_field(1, int(msg.get("event", 0)))
    if msg.get("node"):
        out += _len_field(2, _encode_node(msg["node"]))
    return out


def _decode_node_event(r: _Reader) -> dict:
    msg: dict = {"event": 0}
    while not r.eof():
        f, w = r.tag()
        if f == 1:
            msg["event"] = r.uvarint()
        elif f == 2:
            msg["node"] = _decode_node(r.bytes_())
        else:
            r.skip(w)
    return msg


_ENCODERS = {
    MSG_CREATE_SHARD: _encode_create_shard,
    MSG_CREATE_INDEX: _encode_create_index,
    MSG_DELETE_INDEX: _encode_delete_index,
    MSG_CREATE_FIELD: _encode_create_field,
    MSG_DELETE_FIELD: _encode_delete_field,
    MSG_CREATE_VIEW: _encode_view_msg,
    MSG_DELETE_VIEW: _encode_view_msg,
    MSG_CLUSTER_STATUS: _encode_cluster_status,
    MSG_RESIZE_INSTRUCTION: _encode_resize_instruction,
    MSG_RESIZE_COMPLETE: _encode_resize_complete,
    MSG_SET_COORDINATOR: _encode_coordinator,
    MSG_UPDATE_COORDINATOR: _encode_coordinator,
    MSG_NODE_STATE: _encode_node_state,
    MSG_RECALCULATE_CACHES: lambda msg: b"",
    MSG_NODE_EVENT: _encode_node_event,
    MSG_NODE_STATUS: _encode_node_status,
}

_DECODERS = {
    MSG_CREATE_SHARD: _decode_create_shard,
    MSG_CREATE_INDEX: _decode_create_index,
    MSG_DELETE_INDEX: _decode_delete_index,
    MSG_CREATE_FIELD: _decode_create_field,
    MSG_DELETE_FIELD: _decode_delete_field,
    MSG_CREATE_VIEW: _decode_view_msg,
    MSG_DELETE_VIEW: _decode_view_msg,
    MSG_CLUSTER_STATUS: _decode_cluster_status,
    MSG_RESIZE_INSTRUCTION: _decode_resize_instruction,
    MSG_RESIZE_COMPLETE: _decode_resize_complete,
    MSG_SET_COORDINATOR: _decode_coordinator,
    MSG_UPDATE_COORDINATOR: _decode_coordinator,
    MSG_NODE_STATE: _decode_node_state,
    MSG_RECALCULATE_CACHES: lambda r: {},
    MSG_NODE_EVENT: _decode_node_event,
    MSG_NODE_STATUS: _decode_node_status,
}


def marshal_cluster_message(msg: dict) -> bytes:
    """dict -> [1-byte type][protobuf] (broadcast.go
    MarshalInternalMessage)."""
    typ = _TYPE_BYTES.get(msg.get("type"))
    if typ is None:
        raise ValueError(f"unknown cluster message type: {msg.get('type')}")
    return bytes([typ]) + _ENCODERS[typ](msg)


def unmarshal_cluster_message(data: bytes) -> dict:
    """[1-byte type][protobuf] -> the handler dict shape."""
    if not data:
        raise ValueError("empty cluster message")
    typ = data[0]
    name = _TYPE_NAMES.get(typ)
    if name is None:
        raise ValueError(f"unknown cluster message type byte: {typ}")
    msg = _DECODERS[typ](_Reader(memoryview(data)[1:]))
    msg["type"] = name
    return msg
