"""View: groups fragments by shard under a named layout.

Mirror of the reference's view (view.go:30-426): ``standard`` holds normal
row data, ``standard_YYYY[MM[DD[HH]]]`` hold time-quantum copies, and
``bsig_<field>`` holds BSI bit-planes.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

from ..parallel.mesh import resolve_device
from . import fragment as fragment_mod

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"

# Process-unique view generation tokens: two views that ever carried the
# same (index, field, name) — an index dropped and recreated — must never
# share a stack or memo token, or their independent version counters
# would collide (the ABA that ``id()`` cannot rule out).
_VIEW_GEN = itertools.count(1)


def view_bsi_name(field_name: str) -> str:
    return VIEW_BSI_PREFIX + field_name


class View:
    def __init__(
        self,
        index: str,
        field: str,
        name: str,
        path: Optional[str] = None,
        cache_type: str = "ranked",
        cache_size: int = 50000,
        mutex: bool = False,
        on_create_shard=None,
        row_attr_store=None,
        ack: str = fragment_mod.DEFAULT_ACK,
        device=None,
    ):
        self.index = index
        self.field = field
        self.name = name
        self.path = path
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.mutex = mutex
        # The field's row attributes, handed to every fragment for TopN's
        # attribute filter.
        self.row_attr_store = row_attr_store
        # Ingest ack/durability level and device, threaded down to every
        # fragment.
        self.ack = ack
        self.device = resolve_device(device)
        self.fragments: Dict[int, fragment_mod.Fragment] = {}
        # Callback fired when a shard's fragment first appears — the field
        # broadcasts CreateShardMessage here (view.go:226).
        self.on_create_shard = on_create_shard
        # Bumped on every mutation of any fragment of this view — the
        # engine invalidates its device field stacks against this token
        # instead of walking per-fragment versions each query.  Writers of
        # different shards hold only their own fragment lock, so the bump
        # is an atomic counter (a lost increment would validate a stale
        # device stack forever).
        self._version_counter = itertools.count(1)
        self.version = 0
        # This view's identity in the engine's stack tokens and result-memo
        # keys, beside ``version``.
        self.gen = next(_VIEW_GEN)

    def _bump_version(self) -> int:
        # next() on itertools.count is atomic under the GIL.
        v = next(self._version_counter)
        self.version = v
        return v

    def open(self):
        """Load existing fragments from disk."""
        if self.path is None:
            return
        frag_dir = os.path.join(self.path, "fragments")
        if not os.path.isdir(frag_dir):
            return
        shards = []
        for name in os.listdir(frag_dir):
            if "." in name:  # .cache / .cache.tmp / .snapshotting leftovers
                continue
            try:
                shards.append(int(name))
            except ValueError:
                continue
        for shard in sorted(shards):
            self.fragment_if_not_exists(shard)

    def _fragment_path(self, shard: int) -> Optional[str]:
        if self.path is None:
            return None
        frag_dir = os.path.join(self.path, "fragments")
        os.makedirs(frag_dir, exist_ok=True)
        return os.path.join(frag_dir, str(shard))

    def fragment(self, shard: int) -> Optional[fragment_mod.Fragment]:
        return self.fragments.get(shard)

    def fragment_if_not_exists(self, shard: int) -> fragment_mod.Fragment:
        frag = self.fragments.get(shard)
        if frag is None:
            frag = fragment_mod.Fragment(
                self.index,
                self.field,
                self.name,
                shard,
                path=self._fragment_path(shard),
                cache_type=self.cache_type,
                cache_size=self.cache_size,
                mutex=self.mutex,
                row_attr_store=self.row_attr_store,
                on_touch=self._bump_version,
                view_gen=self.gen,
                ack=self.ack,
                device=self.device,
            )
            self.fragments[shard] = frag
            if self.on_create_shard is not None:
                self.on_create_shard(self.index, self.field, shard)
        return frag

    def shards(self):
        return sorted(self.fragments)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        shard = column_id // fragment_mod.SHARD_WIDTH
        return self.fragment_if_not_exists(shard).set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        shard = column_id // fragment_mod.SHARD_WIDTH
        frag = self.fragments.get(shard)
        if frag is None:
            return False
        return frag.clear_bit(row_id, column_id)

    def value(self, column_id: int, bit_depth: int):
        shard = column_id // fragment_mod.SHARD_WIDTH
        frag = self.fragments.get(shard)
        if frag is None:
            return 0, False
        return frag.value(column_id, bit_depth)

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        shard = column_id // fragment_mod.SHARD_WIDTH
        return self.fragment_if_not_exists(shard).set_value(
            column_id, bit_depth, value
        )

    def clear_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        shard = column_id // fragment_mod.SHARD_WIDTH
        frag = self.fragments.get(shard)
        if frag is None:
            return False
        return frag.clear_value(column_id, bit_depth, value)

    def close(self):
        for frag in self.fragments.values():
            frag.close()

    def __repr__(self) -> str:
        return f"View({self.index}/{self.field}/{self.name}, shards={self.shards()})"
