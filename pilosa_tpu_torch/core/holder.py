"""Holder: root container of all indexes on a node.

Mirror of the reference's Holder (holder.go:50-911): owns the data
directory, opens/closes every index/field/view/fragment and hands fragments
to the executor.  It also fixes the device of every fragment's row mirror:
the card unless the caller asks for the CPU (``parallel.mesh.resolve_device``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..parallel.mesh import resolve_device
from .fragment import Fragment
from .index import Index
from .view import View


class Holder:
    def __init__(
        self,
        path: Optional[str] = None,
        on_create_shard=None,
        ack: Optional[str] = None,
        device=None,
    ):
        self.path = path
        self.device = resolve_device(device)
        self.indexes: Dict[str, Index] = {}
        # Ingest ack/durability level threaded to every fragment this
        # holder creates.
        from .fragment import DEFAULT_ACK

        self.ack = ack if ack is not None else DEFAULT_ACK
        self._user_on_create_shard = on_create_shard
        self.opened = False
        # Guards concurrent index creation (holder.go mu).
        self._mu = threading.RLock()
        # Per-index counters bumped whenever that index's fragment
        # population changes; cheap invalidation tokens for cached shard
        # lists and device stacks (TorchEngine).  Per-index so ingest into
        # one index cannot evict another index's resident stacks.
        self._shard_epochs: Dict[str, int] = {}
        # Schema tombstones: creation_ids of deleted indexes/fields, kept
        # so at-least-once gossip and periodic NodeStatus anti-entropy
        # cannot resurrect a deleted object (creation_id -> local time,
        # GC'd after TOMBSTONE_TTL).
        self.schema_tombstones: Dict[str, float] = {}

    # -- schema tombstones --------------------------------------------------

    MAX_TOMBSTONES = 4096

    def tombstone(self, creation_id: str):
        if not creation_id:
            return
        if creation_id in self.schema_tombstones:
            return
        self.schema_tombstones[creation_id] = time.time()
        # Bounded by count, evicting oldest-inserted (dicts preserve
        # insertion order) — a TTL-only prune grows without bound under
        # delete churn and rebuilds the dict per insert.
        while len(self.schema_tombstones) > self.MAX_TOMBSTONES:
            self.schema_tombstones.pop(next(iter(self.schema_tombstones)))
        self._save_tombstones()

    def is_tombstoned(self, creation_id: Optional[str]) -> bool:
        return bool(creation_id) and creation_id in self.schema_tombstones

    def _tombstones_path(self) -> Optional[str]:
        return (
            os.path.join(self.path, ".tombstones")
            if self.path is not None
            else None
        )

    def _save_tombstones(self):
        p = self._tombstones_path()
        if p is None:
            return
        import json

        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.schema_tombstones, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def _load_tombstones(self):
        p = self._tombstones_path()
        if p is None or not os.path.exists(p):
            return
        import json

        try:
            with open(p) as f:
                self.schema_tombstones.update(json.load(f))
        except (OSError, ValueError):
            pass

    def open(self):
        """Open every index from disk."""
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
            self._load_tombstones()
            for name in sorted(os.listdir(self.path)):
                p = os.path.join(self.path, name)
                if os.path.isdir(p) and not name.startswith("."):
                    idx = self._new_index(name)
                    idx.open()
                    self.indexes[name] = idx
        self.opened = True

    def close(self):
        for idx in self.indexes.values():
            idx.close()
        self.opened = False

    def _index_path(self, name: str) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, name)

    def _new_index(self, name: str, keys: bool = False, track_existence: bool = True) -> Index:
        return Index(
            name,
            path=self._index_path(name),
            keys=keys,
            track_existence=track_existence,
            on_create_shard=self._on_create_shard,
            ack=self.ack,
            device=self.device,
        )

    def _on_create_shard(self, index, field, shard):
        self.bump_shard_epoch(index)
        if self._user_on_create_shard is not None:
            self._user_on_create_shard(index, field, shard)

    def shard_epoch(self, index: str) -> int:
        return self._shard_epochs.get(index, 0)

    def data_versions(self) -> Dict[str, int]:
        """Per-index data-version token: the sum of every view's
        mutation counter plus the shard epoch.  Monotonic under local
        writes — the cheap heartbeat payload peers use to judge replica
        freshness for bounded replica reads (carried in NodeStatus
        exchanges; cluster.note_heartbeat records receipt)."""
        out: Dict[str, int] = {}
        for name, idx in list(self.indexes.items()):
            v = self._shard_epochs.get(name, 0)
            for f in list(idx.fields.values()):
                for view in list(f.views.values()):
                    v += view.version
            out[name] = v
        return out

    def bump_shard_epoch(self, index: str):
        """Call after adding/removing fragments of an index."""
        self._shard_epochs[index] = self._shard_epochs.get(index, 0) + 1

    def set_on_create_shard(self, fn):
        """Install the create-shard broadcast hook (view.go:226) on this
        holder and every already-created index/field/view."""
        self._user_on_create_shard = fn
        for idx in self.indexes.values():
            idx.on_create_shard = self._on_create_shard
            for f in idx.fields.values():
                f.on_create_shard = self._on_create_shard
                for v in f.views.values():
                    v.on_create_shard = self._on_create_shard

    def has_data(self) -> bool:
        """True when the holder contains at least one index — open or
        merely present as a directory under ``path`` (holder.go:221-234
        peeks at the directory listing so an unopened holder can answer
        before ``open()``).  Cluster bootstrap uses this to distinguish
        an empty joining node (instant join) from one carrying data
        (needs a resize job), cluster.go:1716,1747,1801."""
        if self.indexes:
            return True
        if self.path is None or not os.path.isdir(self.path):
            return False
        return any(
            not name.startswith(".")
            and os.path.isdir(os.path.join(self.path, name))
            for name in os.listdir(self.path)
        )

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(
        self, name: str, keys: bool = False, track_existence: bool = True
    ) -> Index:
        with self._mu:
            if name in self.indexes:
                raise ValueError(f"index already exists: {name}")
            return self._create(name, keys, track_existence)

    def create_index_if_not_exists(
        self, name: str, keys: bool = False, track_existence: bool = True
    ) -> Index:
        with self._mu:
            idx = self.indexes.get(name)
            if idx is not None:
                return idx
            return self._create(name, keys, track_existence)

    def _create(self, name: str, keys: bool, track_existence: bool) -> Index:
        from .index import validate_name

        validate_name(name)
        idx = self._new_index(name, keys, track_existence)
        idx.open()
        idx.save_meta()
        self.indexes[name] = idx
        return idx

    def delete_index(self, name: str):
        idx = self.indexes.pop(name, None)
        if idx is None:
            raise ValueError(f"index not found: {name}")
        idx.close()
        self.bump_shard_epoch(name)
        if idx.path and os.path.isdir(idx.path):
            import shutil

            shutil.rmtree(idx.path)

    # -- executor accessors (holder.go fragment/view helpers) --------------

    def fragment(
        self, index: str, field: str, view: str, shard: int
    ) -> Optional[Fragment]:
        idx = self.indexes.get(index)
        if idx is None:
            return None
        f = idx.field(field)
        if f is None:
            return None
        v = f.view(view)
        if v is None:
            return None
        return v.fragment(shard)

    def local_shards(self, index: str) -> List[int]:
        """Sorted union of shards with a local fragment in any field/view
        of the index — the canonical shard axis for the TorchEngine's
        field-stack residency (one stack per (index, field, view),
        regardless of which shard subset a query names)."""
        idx = self.indexes.get(index)
        if idx is None:
            return []
        shards = set()
        # list() snapshots are C-level-atomic under the GIL; concurrent
        # field/view/fragment creation must not blow up this read path.
        for f in list(idx.fields.values()):
            for v in list(f.views.values()):
                shards.update(list(v.fragments))
        return sorted(shards)

    def view(self, index: str, field: str, view: str) -> Optional[View]:
        idx = self.indexes.get(index)
        if idx is None:
            return None
        f = idx.field(field)
        if f is None:
            return None
        return f.view(view)

    def schema(self) -> List[dict]:
        """Schema description for the /schema endpoint."""
        out = []
        for name, idx in sorted(self.indexes.items()):
            fields = []
            for f in idx.public_fields():
                fields.append({"name": f.name, "options": f.options.to_dict()})
            out.append({"name": name, "options": {"keys": idx.keys}, "fields": fields})
        return out

    def __repr__(self) -> str:
        return f"Holder(indexes={sorted(self.indexes)})"
