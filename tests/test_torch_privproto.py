"""The port's cluster wire format (``pilosa_tpu_torch/net/privproto.py``)
against the JAX package's (``pilosa_tpu/net/privproto.py``): every message
of tests/test_privproto.py marshals to the same bytes in both packages, and
each package decodes the other's frames to the same dict, extension fields
(>= 100), negative int64s and proto3 default omission included; the
reference's own cases run against the port too."""

import copy

import numpy as np
import pytest

from pilosa_tpu.net import privproto as jpp
from pilosa_tpu_torch.net import privproto as tpp
from tests.test_privproto import MESSAGES

EXTRA = [
    {"type": "create-field", "index": "i", "field": "v", "cid": "c",
     "meta": {"type": "int", "min": -(1 << 40), "max": -1, "keys": True}},
    {"type": "create-field", "index": "i", "field": "t", "cid": "",
     "meta": {"type": "time", "timeQuantum": "YMD", "noStandardView": True}},
    {"type": "node-status", "node": {"id": "a", "uri": "http://a:1", "state": "DOWN"},
     "state": "DEGRADED", "versions": {"i": 7, "j": 0}, "aePasses": 3,
     "pendingHints": {"b": 2}, "indexes": {}},
    {"type": "resize-complete", "jobId": 7, "error": "fetch failed"},
    {"type": "set-state", "state": "NORMAL"},
]


@pytest.mark.parametrize("msg", MESSAGES + EXTRA, ids=lambda m: m["type"])
def test_bytes_equal_and_each_decodes_the_other(msg):
    jb = jpp.marshal_cluster_message(copy.deepcopy(msg))
    tb = tpp.marshal_cluster_message(copy.deepcopy(msg))
    assert tb == jb
    assert tpp.unmarshal_cluster_message(jb) == jpp.unmarshal_cluster_message(jb)
    assert jpp.unmarshal_cluster_message(tb) == tpp.unmarshal_cluster_message(tb)


@pytest.mark.parametrize("seed", range(4))
def test_random_node_status_frames(seed):
    """Random NodeStatus frames (the biggest message: schema, shards,
    versions) decode alike in both packages."""
    rng = np.random.default_rng(seed)
    idx = {}
    for i in range(int(rng.integers(1, 4))):
        fields = {}
        for f in range(int(rng.integers(1, 4))):
            fields[f"f{f}"] = {
                "options": {"type": "set", "cacheType": "ranked",
                            "cacheSize": int(rng.integers(1, 1 << 20))},
                "cid": f"c{i}{f}", "views": ["standard"],
                "availableShards": sorted(set(rng.integers(0, 5000, 30).tolist())),
            }
        idx[f"i{i}"] = {"keys": bool(rng.integers(0, 2)), "cid": f"ic{i}", "fields": fields}
    msg = {"type": "node-status", "node": {"id": "n", "uri": "http://n:1",
                                           "isCoordinator": True, "state": "READY"},
           "indexes": idx, "tombstones": [f"t{k}" for k in range(int(rng.integers(0, 4)))]}
    tb = tpp.marshal_cluster_message(msg)
    assert tb == jpp.marshal_cluster_message(msg)
    assert tpp.unmarshal_cluster_message(tb) == jpp.unmarshal_cluster_message(tb)


def test_golden_and_unknown_as_the_reference():
    assert tpp.marshal_cluster_message(
        {"type": "create-shard", "index": "i", "field": "f", "shard": 3}
    ) == b"\x00\x0a\x01i\x10\x03\x1a\x01f"
    with pytest.raises(ValueError):
        tpp.marshal_cluster_message({"type": "no-such-message"})
    with pytest.raises(ValueError):
        tpp.unmarshal_cluster_message(b"\x63junk")


def test_int_helpers_are_the_reference():
    """The two's complement and zigzag helpers on the int64 edges."""
    for v in (0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 40, -(1 << 40)):
        assert tpp._to_int64(v & ((1 << 64) - 1)) == jpp._to_int64(v & ((1 << 64) - 1))
        assert tpp._sint_field(7, v) == jpp._sint_field(7, v)
