"""Carrying state over from the JAX package.

The system holds data, not weights, so two things cross over:

- ``stack_from_numpy`` takes a JAX engine's field-stack state as numpy
  (the ``uint32[R, S_padded, W]`` matrix, its row index, its ``uint64[R,
  S_padded]`` occupancy summary and the canonical shard list) and returns
  the port's ``_FieldStack`` on a device.  The JAX engine pads the shard
  axis to a multiple of its mesh size; the port pads nothing, so the
  padding positions are cut off.
- ``open_holder`` opens a data directory written by ``pilosa_tpu``'s
  Holder: index/field metadata, the pilosa-roaring fragment files
  (snapshot plus op-log, read by the port's own copy of the codec) and the
  row and column attribute stores (the sqlite ``.data`` files).
- ``open_translate_store`` opens a ``.keys`` translate log (and its
  ``.keys.idx`` sidecar) written by ``pilosa_tpu``'s TranslateFile, with
  the same ids for the same keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .core.holder import Holder
from .core.translate import TranslateFile
from .ops import bitops
from .parallel.engine import _FieldStack
from .parallel.mesh import host_stack, put_stack, resolve_device


def stack_from_numpy(matrix: np.ndarray, row_index: Dict[int, int],
                     occ: Optional[np.ndarray], shards: List[int],
                     device=None, versions=None) -> _FieldStack:
    """The port's field stack for a JAX stack's host state.  ``occ`` None
    (the JAX package keeps none on multi-process meshes) is recomputed
    from the words."""
    dev = resolve_device(device)
    matrix = np.asarray(matrix)
    if matrix.dtype != np.uint32 or matrix.ndim != 3:
        raise ValueError("matrix must be uint32[R, S, W]")
    S = len(shards)
    if matrix.shape[1] < S:
        raise ValueError(f"matrix has {matrix.shape[1]} shard positions, need {S}")
    buf, host = host_stack((matrix.shape[0], S, matrix.shape[2]), dev)
    host[...] = matrix[:, :S]
    if occ is None:
        occ = np.array(
            [[bitops.occupancy64(host[r, s]) for s in range(S)]
             for r in range(matrix.shape[0])],
            dtype=np.uint64,
        ).reshape(matrix.shape[0], S)
    else:
        occ = np.ascontiguousarray(np.asarray(occ, dtype=np.uint64)[:, :S])
    return _FieldStack(
        put_stack(buf, dev), dict(row_index), versions, list(shards), occ
    )


def open_holder(path: str, device=None) -> Holder:
    """Open a data directory written by ``pilosa_tpu``'s Holder."""
    holder = Holder(path, device=device)
    holder.open()
    return holder


def open_translate_store(path: str) -> TranslateFile:
    """Open a translate log written by ``pilosa_tpu``'s TranslateFile."""
    store = TranslateFile(path)
    store.open()
    return store
