"""Index: a named database of fields.

Mirror of the reference's Index (index.go:30-496): fields map, keys flag,
and the internal ``exists`` existence field (holder.go:45-46,
index.go:123-175) that powers Not() and column counts.  Column attributes
are not ported yet (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Dict, List, Optional

from ..parallel.mesh import resolve_device
from ..roaring import Bitmap
from . import cache as cache_mod
from .field import Field, FieldOptions

EXISTENCE_FIELD_NAME = "exists"


class Index:
    def __init__(
        self,
        name: str,
        path: Optional[str] = None,
        keys: bool = False,
        track_existence: bool = True,
        on_create_shard=None,
        ack: Optional[str] = None,
        device=None,
    ):
        self.name = name
        self.path = path
        self.keys = keys
        self.track_existence = track_existence
        # Ingest ack/durability level and device, threaded to every
        # fragment.
        from .fragment import DEFAULT_ACK

        self.ack = ack if ack is not None else DEFAULT_ACK
        self.device = resolve_device(device)
        # See Field.creation_id: guards delete-index redelivery.
        self.creation_id = uuid.uuid4().hex
        self.fields: Dict[str, Field] = {}
        self._mu = threading.RLock()
        self.on_create_shard = on_create_shard
        if path is not None:
            os.makedirs(path, exist_ok=True)

    # -- metadata ----------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def save_meta(self):
        if self.path is None:
            return
        with open(self._meta_path(), "w") as f:
            json.dump(
                {
                    "keys": self.keys,
                    "trackExistence": self.track_existence,
                    "cid": self.creation_id,
                },
                f,
            )

    def load_meta(self):
        if self.path is None or not os.path.exists(self._meta_path()):
            return
        with open(self._meta_path()) as f:
            doc = json.load(f)
        self.keys = doc.get("keys", False)
        self.track_existence = doc.get("trackExistence", True)
        # See Field._load_meta: creation_id must survive restart.
        if doc.get("cid"):
            self.creation_id = doc["cid"]

    def open(self):
        if self.path is not None:
            self.load_meta()
            self.save_meta()
            for name in sorted(os.listdir(self.path)):
                if name.startswith("."):
                    continue
                p = os.path.join(self.path, name)
                if os.path.isdir(p):
                    f = self._new_field(name)
                    f.open()
                    self.fields[name] = f
        if self.track_existence and EXISTENCE_FIELD_NAME not in self.fields:
            self.create_field_if_not_exists(
                EXISTENCE_FIELD_NAME,
                FieldOptions(cache_type=cache_mod.CACHE_TYPE_NONE, cache_size=0),
            )

    def close(self):
        for f in self.fields.values():
            f.close()

    # -- fields ------------------------------------------------------------

    def _field_path(self, name: str) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, name)

    def _new_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        field_path = self._field_path(name)
        return Field(
            self.name,
            name,
            options=options,
            path=field_path,
            ack=self.ack,
            on_create_shard=self.on_create_shard,
            device=self.device,
        )

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def create_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._mu:
            if name in self.fields:
                raise ValueError(f"field already exists: {name}")
            return self._create(name, options)

    def create_field_if_not_exists(
        self, name: str, options: Optional[FieldOptions] = None
    ) -> Field:
        with self._mu:
            f = self.fields.get(name)
            if f is not None:
                return f
            return self._create(name, options)

    def _create(self, name: str, options: Optional[FieldOptions]) -> Field:
        validate_name(name)
        f = self._new_field(name, options)
        f.save_meta()
        self.fields[name] = f
        return f

    def delete_field(self, name: str):
        f = self.fields.pop(name, None)
        if f is None:
            raise ValueError(f"field not found: {name}")
        if name == EXISTENCE_FIELD_NAME:
            # Deleting the existence field turns tracking OFF, persisted
            # BEFORE the files go — a crash mid-delete must not leave
            # trackExistence=true on disk, or reopen silently recreates
            # the field (index_internal_test.go:54 Existence_Delete).
            self.track_existence = False
            self.save_meta()
        f.close()
        if f.path and os.path.isdir(f.path):
            import shutil

            shutil.rmtree(f.path)

    def existence_field(self) -> Optional[Field]:
        if not self.track_existence:
            return None
        return self.fields.get(EXISTENCE_FIELD_NAME)

    def public_fields(self) -> List[Field]:
        return [
            f for n, f in sorted(self.fields.items()) if n != EXISTENCE_FIELD_NAME
        ]

    # -- shards ------------------------------------------------------------

    def available_shards(self) -> Bitmap:
        """Union of availableShards over all fields (index.go:238)."""
        out = Bitmap()
        for f in self.fields.values():
            out = out.union(f.available_shards())
        return out

    def add_column_existence(self, column_ids):
        ef = self.existence_field()
        if ef is None:
            return
        ef.import_bulk([0] * len(column_ids), list(column_ids))

    def __repr__(self) -> str:
        return f"Index({self.name}, fields={sorted(self.fields)})"


# The internal self-observation index of the JAX package: a reserved
# name, accepted here so its data directories open.
SYSTEM_INDEX = "_system"


def validate_name(name: str):
    """Index/field name validation (pilosa.go name regex), extended with
    exactly one reserved spelling: ``_system``, the internal
    self-observation index.  Every other underscore-prefixed name stays
    invalid so the internal namespace cannot be squatted."""
    import re

    if name == SYSTEM_INDEX:
        return
    if not re.fullmatch(r"[a-z][a-z0-9_-]{0,63}", name):
        raise ValueError(f"invalid name: {name!r}")
