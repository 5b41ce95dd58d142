"""The multi-process mesh on ``torch.distributed`` (the port of
``pilosa_tpu/parallel/multihost.py``).

Each process is one rank with one card, and two ranks may share one card.
Every rank runs the same node program over the same holder data (each
host replays the same data, as in the reference); the canonical shard
axis is padded to a multiple of the world size (``mesh.pad_shards``) and
rank r owns the contiguous block ``[r * k, (r + 1) * k)`` of it
(``mesh.shard_owner``, ``owned_positions``).  A rank's field stacks hold
its block only, ``int32[R, S_pad / world, WORDS]`` at most, so the hand
kernels run unchanged over a smaller shard axis, and a collective on the
host finishes each dispatch where the reference's program ends in a
``psum`` (``all_reduce_sum``) or in ``replicate_shards``
(``all_gather_shards``).

The collectives run on the gloo backend over host copies of the results:
NCCL refuses two ranks on one device, and the mesh's ranks share a card
wherever the machine has one.  ``initialize`` passes an explicit
``timeout``, so that a lost peer stalls a collective for at most that
long, not for gloo's default of 30 minutes; the reference bounds the same
wait with ``SeqGate.STALL_TIMEOUT`` and ``API.MESH_REPLAY_TIMEOUT``.

The node's control plane stays per process: the peers hand each other
their dispatches over HTTP (``server.Server._broadcast_dispatch``), and
the sequencer's tickets order them (``seqgate.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import pad_shards, resolve_device, shard_owner

# Seconds a collective waits for a peer that never joins (the reference's
# API.MESH_REPLAY_TIMEOUT).
COLLECTIVE_TIMEOUT = 120.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the process group: a gloo group over a ``tcp://{coordinator}``
    store (rank 0 listens there), ``num_processes`` ranks, this one
    ``process_id``, each collective waiting at most COLLECTIVE_TIMEOUT for
    a peer.  A no-op when the group is up already or when there is one
    process.  ``WORLD_SIZE`` and ``RANK`` stand in for arguments not
    given."""
    if dist.is_initialized():
        return
    world = int(num_processes or os.environ.get("WORLD_SIZE", 1))
    if world <= 1 or not coordinator_address:
        return
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """The cards this process can see (one on the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def rank_device(rank: int) -> torch.device:
    """A rank's card, ``cuda:{local rank % cards}`` (``LOCAL_RANK``, else
    ``rank``), so that ranks beyond the card count share cards; a caller
    that names a device (the tests: ``cpu``) does not ask."""
    if not torch.cuda.is_available():
        return resolve_device(None)  # raises: no card
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def owned_positions(n_positions: int, world: Optional[int] = None,
                    rank: Optional[int] = None) -> set:
    """The canonical positions (0..n_positions over the padded shard axis)
    this rank owns, through ``mesh.shard_owner``, the one source of
    placement truth."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    return {p for p in range(n_positions) if shard_owner(p, n_positions, world) == rank}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank (the reference's ``psum``), through
    a host copy on the gloo group; the result on ``t``'s device."""
    host = t.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    return host.to(t.device)


def all_gather_shards(t: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Every rank's block of a per-shard result over a canonical axis of
    ``n_shards``, concatenated in rank order over the padded axis (the
    reference's ``replicate_shards``) and cut to ``n_shards``: ``t`` is
    this rank's ``[n_local, ...]``, padded with zeros to the block length;
    the result on ``t``'s device."""
    world = process_count()
    k = pad_shards(n_shards, world) // world
    host = torch.zeros((k,) + tuple(t.shape[1:]), dtype=t.dtype)
    host[: t.shape[0]] = t.detach().cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts)[:n_shards].to(t.device)
