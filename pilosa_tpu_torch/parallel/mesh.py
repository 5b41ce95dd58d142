"""Device choice and field-stack placement on one device.

The JAX package lays shards out along a 1-D device mesh, pads the shard
axis to a multiple of the mesh size and reduces with a ``psum`` over ICI
(``pilosa_tpu/parallel/mesh.py``).  On one card the whole shard axis is
local: a field stack is one contiguous rows-major ``int32[R, S, WORDS]``
tensor with no padding, and the reduce is the kernel's own (a block
reduce plus one atomic add per block).  On a multi-process mesh
(``multihost.py``) the canonical axis is padded to a multiple of the
world size (``pad_shards``) and rank r owns the contiguous block
``[r * k, (r + 1) * k)`` of it (``shard_owner``): its stacks hold that
block only, and a collective on the host finishes each dispatch.

Every entry point of the port runs on the card unless the caller asks for
the CPU: ``resolve_device(None)`` is ``cuda`` and raises when no card is
present, so a missing card can never silently turn a run into a CPU run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default (raising if
    there is no card), or the one the caller names (``"cpu"`` in tests)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def host_stack(shape: Tuple[int, ...], device: torch.device):
    """A zeroed host staging buffer for a field stack, plus its uint32
    numpy view for the host assembly to fill.  Page-locked when the stack
    is headed for the card, so the upload runs at the copy engine's rate
    without a second host copy."""
    pin = device.type == "cuda"
    buf = torch.zeros(shape, dtype=torch.int32, pin_memory=pin)
    return buf, buf.numpy().view(np.uint32)


def put_stack(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Upload an assembled host stack to ``device`` (a no-op on the CPU).
    The copy is synchronous, so the staging buffer may be dropped after."""
    if device.type == "cpu":
        return buf
    return buf.to(device)


def shard_mask(n_shards: int, positions, device: torch.device) -> torch.Tensor:
    """int32[S] requested-shard gate: 1 at the canonical positions of the
    requested shards, 0 elsewhere."""
    host = np.zeros(n_shards, dtype=np.int32)
    host[list(positions)] = 1
    return torch.from_numpy(host).to(device)


def pad_shards(n_shards: int, world: int) -> int:
    """Shard count padded up to a multiple of the mesh size ``world`` (the
    number of ranks), and at least one position a rank."""
    return max(((n_shards + world - 1) // world) * world, world)


def shard_owner(shard_index: int, n_shards_padded: int, world: int) -> int:
    """The rank owning canonical position ``shard_index``.
    ``n_shards_padded`` must be a positive multiple of the mesh size (what
    ``pad_shards`` returns): anything else is a caller bug surfaced
    loudly, not a ZeroDivisionError deep in a dispatch."""
    if n_shards_padded < world or n_shards_padded % world:
        raise ValueError(
            f"n_shards_padded={n_shards_padded} is not a positive "
            f"multiple of the mesh size {world} (use pad_shards)"
        )
    return shard_index // (n_shards_padded // world)
