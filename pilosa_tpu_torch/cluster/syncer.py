"""Anti-entropy: background repair of replica divergence.

Mirror of the reference's holderSyncer + fragmentSyncer
(holder.go:630-911, fragment.go:2170-2390, server.go monitorAntiEntropy
:430-483): walk the schema; for every owned shard compare 100-row block
checksums across replicas, fetch differing blocks, merge by majority
vote, apply locally and push per-peer set/clear diffs as roaring
payloads; diff row/column attributes by block checksum.

A copy of ``pilosa_tpu/cluster/syncer.py``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..core.fragment import SHARD_WIDTH
from ..roaring import Bitmap
from ..util import events as events_mod


class HolderSyncer:
    def __init__(self, holder, cluster, logger=None, journal=None):
        self.holder = holder
        self.cluster = cluster
        self.logger = logger
        # Pass start/end (with repair tallies) land in the structured
        # event journal: anti-entropy progress is an operator-facing
        # fact (/debug/events?type=antientropy), not just a log line.
        self.journal = journal if journal is not None else events_mod.JOURNAL
        self.closing = False
        # Per-pass repair tallies (reset at each sync_holder entry).
        self._pass = {}

    # -- entry (holder.go SyncHolder :659) ---------------------------------

    def sync_holder(self):
        self._pass = {
            "fragments": 0, "blocksSynced": 0,
            "bitsSet": 0, "bitsCleared": 0, "errors": 0,
        }
        # Replay-before-AE ordering (docs/durability.md "Hinted
        # handoff").  Three gates:
        #
        # 0. SYNCHRONOUS pre-pass hint check: fetch every live peer's
        #    current pendingHints (GET /status) before merging.
        #    Gossiped advertisements alone lose a race this pass must
        #    never lose — a node whose partition was shorter than its
        #    own failure detection never convicts its peers, so its
        #    first post-heal pass would push its stale bits back onto
        #    survivors that just acked clears (reverting them) before
        #    any broadcast advertisement could land.  An unreachable
        #    peer defers the whole pass: merging while a link is in an
        #    unknown state is exactly the revert window.
        # 1. Peers still advertise un-replayed hints targeting THIS
        #    node: this pass must NOT run — merging majority-tie-to-set
        #    against replicas while we still hold bits a queued clear
        #    will remove would resurrect them on the healthy side.
        #    Defer (journaled, NOT counted as a clean pass, so
        #    ae_passes stays put and the bounded-read quarantine holds).
        # 2. WE hold hints for some peer: drain what we can first, and
        #    _replicas below excludes any peer whose queue didn't fully
        #    drain — our clears must land via replay before that
        #    replica's blocks are merged.
        if not self._refresh_peer_hints():
            self.journal.append(
                "antientropy.deferred", node=self.cluster.node.id,
                reason="peer-unreachable",
            )
            return
        if self.cluster.hints_pending_for(self.cluster.node.id) > 0:
            self.journal.append(
                "antientropy.deferred", node=self.cluster.node.id,
                reason="pending-hints",
                pendingHintsForMe=self.cluster.hints_pending_for(
                    self.cluster.node.id
                ),
            )
            return
        if self.cluster.hints is not None:
            self.cluster.hints.replay_pending()
        t0 = time.monotonic()
        self.journal.append("antientropy.start", node=self.cluster.node.id)
        clean = False
        try:
            self._sync_all()
            # Only a pass that ran to completion (not cut short by
            # closing, no raise, no per-fragment errors) reconciled
            # every shard this node owns against its replicas.
            clean = not self.closing and not self._pass.get("errors")
        finally:
            if clean:
                # Advertise it (NodeStatus "aePasses") so peers release
                # their bounded-read quarantine of us — an aborted or
                # erroring pass must NOT, or a recovering node would be
                # readmitted to bounded reads before its missed writes
                # are actually healed (docs/durability.md).
                self.cluster.ae_passes += 1
            self.journal.append(
                "antientropy.end",
                node=self.cluster.node.id,
                seconds=round(time.monotonic() - t0, 6),
                **self._pass,
            )

    # How long a freshly-convicted DOWN member defers passes (the
    # detection-skew guard in _refresh_peer_hints).  Generously above
    # any gossip suspicion timeout (default 4 s) and bounded so a
    # permanent death cannot suspend anti-entropy indefinitely.
    DARK_MEMBER_DEFER = 30.0

    def _refresh_peer_hints(self) -> bool:
        """Synchronously refresh every live peer's pending-hint
        advertisement (GET /status) before a pass.  Returns False —
        defer — when any live peer cannot be reached or answers
        without the hint fields (mid-upgrade peer: its hint state is
        unknowable, same uncertainty as unreachable... except a
        pre-hint peer never will, so absent fields on a REACHABLE peer
        count as an empty advertisement to avoid wedging mixed
        clusters)."""
        cluster = self.cluster
        for node in list(cluster.nodes):
            if node.id == cluster.node.id:
                continue
            if node.state == "DOWN":
                # A DOWN-marked member's hint queue is unknowable — and
                # it is exactly the node most likely to HOLD hints (the
                # coordinator that kept acking while THIS node was the
                # partitioned side sees us as DOWN and vice versa; an
                # asymmetric detection can leave either view).  With
                # hinted handoff enabled, merging while any member's
                # hint state is dark IS the resurrect window — defer,
                # but BOUNDED: the race only lives in the detection-
                # skew window around a partition (one side convicted,
                # the other not yet — once both convict, each side
                # defers on its own view).  A member CONTINUOUSLY down
                # past the bound is the pre-hint long-outage regime, where
                # survivors must keep repairing each other — an
                # unbounded defer would suspend cluster-wide repair
                # (and wedge unrelated quarantine releases) for the
                # whole outage.  Without a manager (pre-hint cluster)
                # the pre-hint behavior stands throughout.
                down_for = time.monotonic() - cluster._down_since.get(
                    node.id, 0.0
                )
                if (
                    cluster.hints is not None
                    and down_for < self.DARK_MEMBER_DEFER
                ):
                    return False
                continue
            try:
                st = cluster.client(node).status()
            except Exception:  # noqa: BLE001 — unreachable = uncertain
                return False
            cluster.note_heartbeat(
                node.id,
                pending_hints=st.get("pendingHints") or {},
                ae_passes=st.get("aePasses"),
            )
        return True

    def _sync_all(self):
        for index_name, idx in list(self.holder.indexes.items()):
            self._sync_index_attrs(index_name, idx)
            for field_name, f in list(idx.fields.items()):
                if self.closing:
                    return
                self._sync_field_attrs(index_name, field_name, f)
                for view_name, view in list(f.views.items()):
                    for shard in list(view.fragments):
                        if self.closing:
                            return
                        if not self.cluster.owns_shard(
                            self.cluster.node.id, index_name, shard
                        ):
                            continue
                        try:
                            self._pass["fragments"] += 1
                            self.sync_fragment(
                                index_name, field_name, view_name, shard
                            )
                        except Exception as e:
                            self._pass["errors"] += 1
                            if self.logger:
                                self.logger.printf(
                                    "sync %s/%s/%s/%d failed: %s",
                                    index_name,
                                    field_name,
                                    view_name,
                                    shard,
                                    e,
                                )

    # -- fragment sync (fragment.go syncFragment :2191) --------------------

    def _replicas(self, index: str, shard: int):
        return [
            n
            for n in self.cluster.shard_nodes(index, shard)
            if n.id != self.cluster.node.id
            and n.state != "DOWN"
            # A replica ANY node still holds un-replayed hints for
            # (ours locally, or peer-advertised via NodeStatus
            # pendingHints) is missing writes the majority-tie merge
            # would undo — a queued clear's bit is still SET there, and
            # merging it from a THIRD replica resurrects the bit just
            # as surely as merging it ourselves.  Replay must land
            # first.
            and self.cluster.hints_pending_for(n.id) == 0
        ]

    def sync_fragment(self, index: str, field: str, view: str, shard: int):
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            return
        replicas = self._replicas(index, shard)
        if not replicas:
            return

        local_blocks = dict(frag.checksum_blocks())
        # Gather remote checksums; any differing or missing block syncs.
        # A replica MISSING the whole fragment counts as all-empty
        # blocks and still receives the push (fragment.go:2213 treats
        # ErrFragmentNotFound as no blocks, not as a failure) — this is
        # how a replica that never saw an index/shard gets seeded.
        remote_blocks = []
        for node in replicas:
            remote_blocks.append(
                {
                    b["id"]: bytes.fromhex(b["checksum"])
                    for b in self._peer_blocks(node, index, field, view, shard)
                }
            )
        block_ids = set(local_blocks)
        for rb in remote_blocks:
            block_ids.update(rb)
        for blk in sorted(block_ids):
            checksums = [local_blocks.get(blk)] + [
                rb.get(blk) for rb in remote_blocks
            ]
            if all(c == checksums[0] for c in checksums):
                continue
            self._sync_block(frag, index, field, view, shard, blk, replicas)

    def _peer_blocks(self, node, index, field, view, shard):
        from ..net.client import ClientError

        try:
            return self.cluster.client(node).fragment_blocks(
                index, field, view, shard
            )
        except ClientError as e:
            if e.code == 404:  # fragment not found = all-empty blocks
                return []
            raise

    def _peer_block_data(self, node, index, field, view, shard, block):
        from ..net.client import ClientError

        try:
            return self.cluster.client(node).block_data(
                index, field, view, shard, block
            )
        except ClientError as e:
            if e.code == 404:
                return {"rows": [], "cols": []}
            raise

    def _sync_block(self, frag, index, field, view, shard, block, replicas):
        """fragment.go syncBlock :2262-2360."""
        peer_pairs = []
        for node in replicas:
            data = self._peer_block_data(node, index, field, view, shard, block)
            peer_pairs.append(
                (
                    np.asarray(data["rows"], dtype=np.uint64),
                    np.asarray(data["cols"], dtype=np.uint64),
                )
            )
        sets, clears = frag.merge_block(block, peer_pairs)
        self._pass["blocksSynced"] = self._pass.get("blocksSynced", 0) + 1
        self._pass["bitsSet"] = (
            self._pass.get("bitsSet", 0) + sum(len(s) for s in sets)
        )
        self._pass["bitsCleared"] = (
            self._pass.get("bitsCleared", 0) + sum(len(c) for c in clears)
        )
        # Push per-peer diffs as roaring payloads (bitsToRoaringData).
        for node, s, c in zip(replicas, sets, clears):
            if s:
                self.cluster.client(node).import_roaring(
                    index, field, shard, _pairs_to_roaring(s), view=view
                )
            if c:
                self.cluster.client(node).import_roaring(
                    index,
                    field,
                    shard,
                    _pairs_to_roaring(c),
                    view=view,
                    clear=True,
                )

    # -- attr sync (holder.go :723-815) ------------------------------------

    def _sync_index_attrs(self, index_name: str, idx):
        if idx.column_attr_store is None:
            return
        for node in self.cluster.nodes:
            if node.id == self.cluster.node.id or node.state == "DOWN":
                continue
            try:
                blocks = [
                    {"id": b, "checksum": d.hex()}
                    for b, d in idx.column_attr_store.blocks()
                ]
                attrs = self.cluster.client(node).index_attr_diff(
                    index_name, blocks
                )
                if attrs:
                    idx.column_attr_store.set_bulk_attrs(
                        {int(k): v for k, v in attrs.items()}
                    )
            except Exception as e:
                if self.logger:
                    self.logger.printf("index attr sync failed: %s", e)

    def _sync_field_attrs(self, index_name: str, field_name: str, f):
        if f.row_attr_store is None:
            return
        for node in self.cluster.nodes:
            if node.id == self.cluster.node.id or node.state == "DOWN":
                continue
            try:
                blocks = [
                    {"id": b, "checksum": d.hex()}
                    for b, d in f.row_attr_store.blocks()
                ]
                attrs = self.cluster.client(node).field_attr_diff(
                    index_name, field_name, blocks
                )
                if attrs:
                    f.row_attr_store.set_bulk_attrs(
                        {int(k): v for k, v in attrs.items()}
                    )
            except Exception as e:
                if self.logger:
                    self.logger.printf("field attr sync failed: %s", e)


def _pairs_to_roaring(pairs: List[tuple]) -> bytes:
    """(row, in-shard col) pairs -> serialized roaring positions
    (fragment.go bitsToRoaringData :2377)."""
    bm = Bitmap(
        int(r) * SHARD_WIDTH + (int(c) % SHARD_WIDTH) for r, c in pairs
    )
    return bm.to_bytes()
