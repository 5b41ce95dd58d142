"""Field: a typed container of views.

Mirror of the reference's Field (field.go:61-1453): five types —

- ``set``    standard rows, ranked/LRU TopN cache
- ``int``    BSI bit-planes in a ``bsig_<name>`` view, min/max bounds
- ``time``   standard + time-quantum views
- ``mutex``  at most one row per column
- ``bool``   rows 0 (false) / 1 (true)

plus an available-shards bitmap (field.go:228-317) and the row attribute
store, ``<field>/.data`` (``core/attrs.py``).  The ``keys`` option marks a
field whose rows the API translates from string keys (``core/translate.py``).
"""

from __future__ import annotations

import datetime as dt
import json
import os
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..parallel.mesh import resolve_device
from ..roaring import Bitmap
from ..util import fanout
from . import cache as cache_mod
from . import rowstore
from . import timequantum
from .attrs import AttrStore
from .fragment import (  # noqa: F401
    DEFAULT_ACK,
    FALSE_ROW_ID,
    SHARD_WIDTH,
    TRUE_ROW_ID,
)
from .row import Row
from .view import VIEW_STANDARD, View, view_bsi_name

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"

VALID_FIELD_TYPES = {
    FIELD_TYPE_SET,
    FIELD_TYPE_INT,
    FIELD_TYPE_TIME,
    FIELD_TYPE_MUTEX,
    FIELD_TYPE_BOOL,
}


class FieldOptions:
    def __init__(
        self,
        type: str = FIELD_TYPE_SET,
        cache_type: str = cache_mod.CACHE_TYPE_RANKED,
        cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
        min: int = 0,
        max: int = 0,
        time_quantum: str = "",
        keys: bool = False,
        no_standard_view: bool = False,
    ):
        self.type = type
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.min = min
        self.max = max
        self.time_quantum = time_quantum
        self.keys = keys
        self.no_standard_view = no_standard_view

    def validate(self):
        if self.type not in VALID_FIELD_TYPES:
            raise ValueError(f"invalid field type: {self.type}")
        if self.cache_type not in cache_mod.VALID_CACHE_TYPES:
            raise ValueError(f"invalid cache type: {self.cache_type}")
        if self.type == FIELD_TYPE_INT and self.min > self.max:
            raise ValueError("invalid bsiGroup range")
        if self.type == FIELD_TYPE_TIME and not timequantum.valid_quantum(
            self.time_quantum
        ):
            raise ValueError(f"invalid time quantum: {self.time_quantum}")

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "timeQuantum": self.time_quantum,
            "keys": self.keys,
            "noStandardView": self.no_standard_view,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FieldOptions":
        return cls(
            type=d.get("type", FIELD_TYPE_SET),
            cache_type=d.get("cacheType", cache_mod.CACHE_TYPE_RANKED),
            cache_size=d.get("cacheSize", cache_mod.DEFAULT_CACHE_SIZE),
            min=d.get("min", 0),
            max=d.get("max", 0),
            time_quantum=d.get("timeQuantum", ""),
            keys=d.get("keys", False),
            no_standard_view=d.get("noStandardView", False),
        )


class BSIGroup:
    """Range-encoded row group (field.go bsiGroup :1356-1438)."""

    def __init__(self, name: str, min_val: int, max_val: int):
        self.name = name
        self.min = min_val
        self.max = max_val

    def bit_depth(self) -> int:
        for i in range(63):
            if self.max - self.min < (1 << i):
                return i
        return 63

    def base_value(self, op: str, value: int) -> Tuple[int, bool]:
        """Rebase a predicate against min; returns (base, out_of_range).
        Mirrors field.go baseValue including its GT/LT edge quirks."""
        base = 0
        if op in (">", ">="):
            if value > self.max:
                return 0, True
            if value > self.min:
                base = value - self.min
        elif op in ("<", "<="):
            if value < self.min:
                return 0, True
            if value > self.max:
                base = self.max - self.min
            else:
                base = value - self.min
        elif op in ("==", "!="):
            if value < self.min or value > self.max:
                return 0, True
            base = value - self.min
        return base, False

    def base_value_between(self, lo: int, hi: int) -> Tuple[int, int, bool]:
        if hi < self.min or lo > self.max:
            return 0, 0, True
        base_lo = lo - self.min if lo > self.min else 0
        if hi > self.max:
            base_hi = self.max - self.min
        elif hi > self.min:
            base_hi = hi - self.min
        else:
            base_hi = 0
        return base_lo, base_hi, False


class Field:
    def __init__(
        self,
        index: str,
        name: str,
        options: Optional[FieldOptions] = None,
        path: Optional[str] = None,
        on_create_shard=None,
        ack: str = DEFAULT_ACK,
        device=None,
    ):
        self.index = index
        self.name = name
        self.path = path
        self.ack = ack
        self.device = resolve_device(device)
        self.options = options or FieldOptions()
        self.options.validate()
        # Unique creation id: schema broadcasts carry it so a delete only
        # ever applies to the incarnation it was issued against (gossip
        # delivery is at-least-once and unordered; wall clocks are not
        # comparable across nodes).  Receivers adopt the originator's id.
        self.creation_id = uuid.uuid4().hex
        self.views: Dict[str, View] = {}
        self.on_create_shard = on_create_shard
        if path is not None:
            os.makedirs(path, exist_ok=True)
        # Row attributes (field.go RowAttrStore; BoltDB ".data" file).
        self.row_attr_store = AttrStore(os.path.join(path, ".data") if path else None)
        self.bsi_groups: List[BSIGroup] = []
        if self.options.type == FIELD_TYPE_INT:
            self.bsi_groups.append(
                BSIGroup(name, self.options.min, self.options.max)
            )
        # Shards known to exist anywhere in the cluster for this field.
        self.remote_available_shards = Bitmap()
        # Bumped on every remote-availability change: executors cache
        # the per-index default shard list against (shard_epoch, this)
        # instead of re-unioning field bitmaps per query (np.unique in
        # Index.available_shards measured as the top serving-tier CPU
        # cost on a 1-core host).
        self.avail_version = 0
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load_meta()

    # -- metadata persistence ---------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def _load_meta(self):
        p = self._meta_path()
        if os.path.exists(p):
            with open(p) as f:
                doc = json.load(f)
            # Old format: the whole file is the options dict.
            opts = doc.get("options", doc) if isinstance(doc, dict) else doc
            self.options = FieldOptions.from_dict(opts)
            # creation_id must survive restart: a fresh uuid after reopen
            # would make this node ignore deletes of its own fields and
            # re-advertise them under an untombstoned id.
            cid = doc.get("cid") if isinstance(doc, dict) else None
            if cid:
                self.creation_id = cid
            self.bsi_groups = []
            if self.options.type == FIELD_TYPE_INT:
                self.bsi_groups.append(
                    BSIGroup(self.name, self.options.min, self.options.max)
                )

    def save_meta(self):
        if self.path is None:
            return
        with open(self._meta_path(), "w") as f:
            json.dump(
                {"options": self.options.to_dict(), "cid": self.creation_id}, f
            )

    def open(self):
        if self.path is None:
            return
        self.save_meta()
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for name in os.listdir(views_dir):
                self.view_if_not_exists(name).open()
        self._load_available_shards()

    def close(self):
        self._save_available_shards()
        for view in self.views.values():
            view.close()
        self.row_attr_store.close()

    # -- available shards (field.go:228-317) -------------------------------

    def local_available_shards(self) -> Bitmap:
        shards = set()
        for view in self.views.values():
            shards.update(view.shards())
        return Bitmap(shards)

    def available_shards(self) -> Bitmap:
        return self.local_available_shards().union(self.remote_available_shards)

    def add_remote_available_shards(self, b: Bitmap):
        self.remote_available_shards = self.remote_available_shards.union(b)
        self.avail_version += 1
        self._save_available_shards()

    def remove_available_shard(self, shard: int):
        """Drop a shard from the REMOTE set (field.go
        RemoveAvailableShard :305 — local shards, derived from actual
        fragments, always remain)."""
        remaining = set(self.remote_available_shards) - {shard}
        self.remote_available_shards = Bitmap(remaining)
        self.avail_version += 1
        self._save_available_shards()

    def _available_shards_path(self) -> str:
        return os.path.join(self.path, ".available.shards")

    def _save_available_shards(self):
        if self.path is None:
            return
        with open(self._available_shards_path(), "wb") as f:
            self.remote_available_shards.write_to(f)

    def _load_available_shards(self):
        if self.path is None:
            return
        p = self._available_shards_path()
        if os.path.exists(p):
            with open(p, "rb") as f:
                data = f.read()
            if data:
                self.remote_available_shards = Bitmap.from_bytes(data)

    # -- views ------------------------------------------------------------

    def _view_path(self, name: str) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, "views", name)

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def view_if_not_exists(self, name: str) -> View:
        v = self.views.get(name)
        if v is None:
            v = View(
                self.index,
                self.name,
                name,
                path=self._view_path(name),
                cache_type=self.options.cache_type,
                cache_size=self.options.cache_size,
                mutex=self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL),
                on_create_shard=self.on_create_shard,
                row_attr_store=self.row_attr_store,
                ack=self.ack,
                device=self.device,
            )
            self.views[name] = v
        return v

    def time_quantum(self) -> str:
        return self.options.time_quantum

    def bsi_group(self, name: str) -> Optional[BSIGroup]:
        for g in self.bsi_groups:
            if g.name == name:
                return g
        return None

    def bit_depth(self) -> int:
        g = self.bsi_group(self.name)
        return g.bit_depth() if g else 0

    # -- writes ------------------------------------------------------------

    def set_bit(
        self, row_id: int, col_id: int, timestamp: Optional[dt.datetime] = None
    ) -> bool:
        """field.go SetBit :802-840: standard view plus a view per time
        quantum unit when a timestamp is given."""
        changed = False
        if not self.options.no_standard_view:
            changed |= self.view_if_not_exists(VIEW_STANDARD).set_bit(row_id, col_id)
        if timestamp is None:
            return changed
        if self.options.type != FIELD_TYPE_TIME:
            raise ValueError(f"cannot set timestamp on {self.options.type} field")
        for name in timequantum.views_by_time(
            VIEW_STANDARD, timestamp, self.time_quantum()
        ):
            changed |= self.view_if_not_exists(name).set_bit(row_id, col_id)
        return changed

    def clear_bit(self, row_id: int, col_id: int) -> bool:
        changed = False
        for view in self.views.values():
            if view.name == VIEW_STANDARD or view.name.startswith(
                VIEW_STANDARD + "_"
            ):
                changed |= view.clear_bit(row_id, col_id)
        return changed

    def set_value(self, col_id: int, value: int) -> bool:
        g = self.bsi_group(self.name)
        if g is None:
            raise ValueError(f"field {self.name} has no int range")
        if value < g.min or value > g.max:
            raise ValueError(
                f"value {value} out of range [{g.min},{g.max}] for field {self.name}"
            )
        base = value - g.min
        view = self.view_if_not_exists(view_bsi_name(self.name))
        return view.set_value(col_id, g.bit_depth(), base)

    def value(self, col_id: int) -> Tuple[int, bool]:
        g = self.bsi_group(self.name)
        if g is None:
            raise ValueError(f"field {self.name} has no int range")
        view = self.view(view_bsi_name(self.name))
        if view is None:
            return 0, False
        base, exists = view.value(col_id, g.bit_depth())
        if not exists:
            return 0, False
        return base + g.min, True

    def clear_value(self, col_id: int) -> bool:
        g = self.bsi_group(self.name)
        view = self.view(view_bsi_name(self.name))
        if view is None or g is None:
            return False
        base, exists = view.value(col_id, g.bit_depth())
        if not exists:
            return False
        return view.clear_value(col_id, g.bit_depth(), base)

    # -- reads -------------------------------------------------------------

    def row(self, row_id: int) -> Row:
        return self._view_row(self.view(VIEW_STANDARD), row_id)

    def row_time(self, row_id: int, t: dt.datetime, quantum: str) -> Row:
        """Row as of the finest unit of ``quantum`` at time ``t`` (field.go
        RowTime :666: viewsByTime(...)[0] for the quantum's last unit).  The
        empty quantum has no unit views, so it is invalid here even though
        fields may carry it."""
        if not quantum or not timequantum.valid_quantum(quantum):
            raise ValueError(f"invalid time quantum: {quantum!r}")
        names = timequantum.views_by_time(VIEW_STANDARD, t, quantum[-1])
        return self._view_row(self.view(names[0]) if names else None, row_id)

    def _view_row(self, view, row_id: int) -> Row:
        if view is None:
            return Row()
        out = Row()
        for shard, frag in view.fragments.items():
            out.segments[shard] = frag.device_row(row_id)
        return out

    # -- bulk import -------------------------------------------------------

    def import_bulk(
        self,
        row_ids,
        column_ids,
        timestamps: Optional[List[Optional[dt.datetime]]] = None,
        clear: bool = False,
    ) -> int:
        """field.go Import :1058: group bits by (view, shard) incl. time
        quantum fanout, then bulk-import per fragment.  ``clear`` removes
        the given bits instead (api.go ImportOptions.Clear).

        Timestamped imports require a time-quantum field and reject
        clear (field.go Import validation): a silent drop of the time
        fanout would leave time views missing bits."""
        if timestamps is not None and any(t is not None for t in timestamps):
            if clear:
                raise ValueError(
                    "import clear is not supported with timestamps"
                )
            if not self.time_quantum():
                raise ValueError(
                    f"field {self.name!r} has no time quantum: cannot "
                    "import with timestamps"
                )
        else:
            # Hot path (no time fan-out): vectorized shard grouping.
            return self._import_bulk_fast(row_ids, column_ids, clear)
        groups: Dict[str, Dict[int, Tuple[list, list]]] = {}

        def put(view_name, shard, r, c):
            rows, cols = groups.setdefault(view_name, {}).setdefault(
                shard, ([], [])
            )
            rows.append(r)
            cols.append(c)
        for i, (r, c) in enumerate(zip(row_ids, column_ids)):
            t = timestamps[i] if timestamps else None
            shard = c // SHARD_WIDTH
            if not (t and self.options.no_standard_view):
                put(VIEW_STANDARD, shard, r, c)
            if t is not None:
                for name in timequantum.views_by_time(
                    VIEW_STANDARD, t, self.time_quantum()
                ):
                    put(name, shard, r, c)
        changed = 0
        for view_name, shards in groups.items():
            view = self.view_if_not_exists(view_name)
            for shard, (rows, cols) in shards.items():
                frag = view.fragment_if_not_exists(shard)
                changed += frag.bulk_import(rows, cols, clear=clear)
        return changed

    # Distinct shards the native partition's tables hold; a batch over
    # more takes the argsort path.
    _NATIVE_SPLIT_MAX_SHARDS = 4096

    @staticmethod
    def _shard_groups(view, cols: np.ndarray, *parallel: np.ndarray):
        """Group column-parallel arrays by shard: yields
        ``(fragment, cols_slice, *parallel_slices)`` per shard, order
        within a shard preserved (last-write-wins paths depend on it):
        the native stable counting sort where it loads
        (native/sparse_merge.cpp sm_shard_split), else ONE stable argsort
        over the shard keys."""
        if len(parallel) == 1 and cols.dtype == np.int64:
            lib = rowstore._merge_lib()
            if lib is not None:
                groups = Field._shard_groups_native(lib, view, cols, parallel[0])
                if groups is not None:
                    return groups
        shards = cols // SHARD_WIDTH
        uniq = np.unique(shards)
        order = np.argsort(shards, kind="stable")
        cols = cols[order]
        parallel = tuple(a[order] for a in parallel)
        starts = np.searchsorted(shards[order], uniq)
        bounds = np.append(starts, cols.size)
        out = []
        for k, s in enumerate(uniq.tolist()):
            frag = view.fragment_if_not_exists(int(s))
            lo, hi = bounds[k], bounds[k + 1]
            out.append(
                (frag, cols[lo:hi]) + tuple(a[lo:hi] for a in parallel)
            )
        return out

    @staticmethod
    def _shard_groups_native(lib, view, cols, par):
        """The native shard partition; None when it declines (more distinct
        shards than its tables hold)."""
        n = cols.size
        cols_c = np.ascontiguousarray(cols)
        par_c = np.ascontiguousarray(par, dtype=np.int64)
        cols_out = np.empty(n, dtype=np.int64)
        par_out = np.empty(n, dtype=np.int64)
        cap = Field._NATIVE_SPLIT_MAX_SHARDS
        sids = np.empty(cap, dtype=np.int64)
        bnds = np.empty(cap + 1, dtype=np.int64)
        ns = lib.sm_shard_split(cols_c.ctypes.data, par_c.ctypes.data, n,
                                int(SHARD_WIDTH.bit_length() - 1), cap, cols_out.ctypes.data,
                                par_out.ctypes.data, sids.ctypes.data, bnds.ctypes.data)
        if ns < 0:
            return None
        b = bnds.tolist()
        return [(view.fragment_if_not_exists(int(s)), cols_out[b[k]: b[k + 1]],
                 par_out[b[k]: b[k + 1]]) for k, s in enumerate(sids[:ns].tolist())]

    def _import_bulk_fast(self, row_ids, column_ids, clear: bool) -> int:
        rows = np.asarray(row_ids, dtype=np.int64)
        cols = np.asarray(column_ids, dtype=np.int64)
        if rows.size == 0:
            return 0
        view = self.view_if_not_exists(VIEW_STANDARD)
        groups = self._shard_groups(view, cols, rows)
        if len(groups) == 1:
            frag, c, r = groups[0]
            return frag.bulk_import(r, c, clear=clear)
        # Each fragment has its own lock: the per-fragment applies run
        # concurrently (util/fanout.py).
        return sum(fanout.run_fanout(
            [lambda f=frag, r=r, c=c: f.bulk_import(r, c, clear=clear)
             for frag, c, r in groups]))

    def import_values(self, column_ids, values, clear: bool = False,
                      fresh: bool = False) -> None:
        """BSI bulk write (field.go importValue): group the columns by shard
        and apply each group with ``Fragment.import_values`` (the last
        write of a column wins).  Every value is range-checked first, so a
        bad one raises before any of the batch applies.  ``clear`` removes
        the columns' not-null bit; ``fresh`` is the caller's promise that
        the columns hold no value yet (a set-only write)."""
        g = self.bsi_group(self.name)
        if g is None:
            raise ValueError(f"field {self.name} has no int range")
        cols = np.asarray(column_ids, dtype=np.int64)
        vals = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        bad = (vals < g.min) | (vals > g.max)
        if bad.any():
            raise ValueError(
                f"value {int(vals[np.argmax(bad)])} out of range for field {self.name}"
            )
        view = self.view_if_not_exists(view_bsi_name(self.name))
        depth = g.bit_depth()
        groups = self._shard_groups(view, cols, vals - g.min)
        if len(groups) == 1:
            frag, c, v = groups[0]
            frag.import_values(c, v, depth, clear=clear, fresh=fresh)
            return
        fanout.run_fanout(
            [lambda f=frag, c=c, v=v: f.import_values(c, v, depth, clear=clear, fresh=fresh)
             for frag, c, v in groups])

    def __repr__(self) -> str:
        return f"Field({self.index}/{self.name}, type={self.options.type})"
