"""The host's C++ components (a copy of ``pilosa_tpu/native``), loaded with
ctypes:

- ``roaring_codec``: fragment-file decode and encode (``roaring/codec.py``
  ``serialize`` and ``deserialize``);
- ``sparse_merge``: the bulk-ingest sorted merge, dense apply and shard
  split (``core/rowstore.py``, ``core/field.py``).

Each source compiles with g++ at first use into
``build/native/lib<name>-<digest>.so`` at the root of the checkout (the
digest covers the source and the flags, so an edited source is never
served from a stale library), once per process.  Loading never raises: a
host without a compiler gets None, and the callers take their numpy paths,
which stay the differential oracles (``tests/test_torch_native.py``).  A
library's presence is the only switch.  This is host code: nothing of the
device path runs here; ``chip_smoke.py``'s native phase times each path
against its numpy twin on the card's host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# No -march=native: a checkout's build directory may travel to a host with
# another CPU.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
# name -> loaded CDLL or None; presence means a load was attempted.
_libs: dict = {}


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return False


def _load(name: str, configure):
    """Get, or build, or fail to build ``name``'s library;
    ``configure(lib)`` checks its ABI stamp and sets the prototypes,
    returning False to reject it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None  # one attempt per process
        path = lib_path(name)
        if not path.exists() and not _build(name, path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        if not configure(lib):
            return None
        _libs[name] = lib
        return lib


def _configure_codec(lib) -> bool:
    lib.rc_abi_version.restype = ctypes.c_int32
    if lib.rc_abi_version() != 2:
        return False
    lib.rc_decoded_bound.restype = ctypes.c_int64
    lib.rc_decoded_bound.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.rc_deserialize.restype = ctypes.c_int64
    lib.rc_deserialize.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64)]
    lib.rc_serialize.restype = ctypes.c_int64
    lib.rc_serialize.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                 ctypes.c_size_t]
    return True


def _configure_merge(lib) -> bool:
    lib.sm_abi_version.restype = ctypes.c_int32
    if lib.sm_abi_version() != 1:
        return False
    split_args = [
        ctypes.c_void_p,  # a_rows (int64*)
        ctypes.c_void_p,  # a_ptrs (const uint32* const*)
        ctypes.c_void_p,  # a_lens (int64*)
        ctypes.c_int64,   # a_nrows
        ctypes.c_void_p,  # b (int64*)
        ctypes.c_int64,   # nb
        ctypes.c_int32,   # exp
        ctypes.c_uint32,  # mask
        ctypes.c_void_p,  # pos_out (uint32*)
        ctypes.c_void_p,  # rows_out (int64*)
        ctypes.c_void_p,  # bounds_out (int64*)
        ctypes.POINTER(ctypes.c_int64),  # n_merged
    ]
    for fn in (lib.sm_union_split, lib.sm_diff_split):
        fn.restype = ctypes.c_int64
        fn.argtypes = split_args
    lib.sm_apply_dense.restype = ctypes.c_int64
    lib.sm_apply_dense.argtypes = [
        ctypes.c_void_p,  # words (uint64*)
        ctypes.c_int64,   # n_words
        ctypes.c_void_p,  # pos (uint32*)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # clear
    ]
    lib.sm_shard_split.restype = ctypes.c_int64
    lib.sm_shard_split.argtypes = [
        ctypes.c_void_p,  # cols (int64*)
        ctypes.c_void_p,  # rows (int64*)
        ctypes.c_int64,   # n
        ctypes.c_int32,   # exp
        ctypes.c_int64,   # max_shards
        ctypes.c_void_p,  # cols_out
        ctypes.c_void_p,  # rows_out
        ctypes.c_void_p,  # shard_ids_out
        ctypes.c_void_p,  # bounds_out
    ]
    return True


def load():
    """The roaring codec library, built at first use; None if unavailable."""
    return _load("roaring_codec", _configure_codec)


def load_merge():
    """The sparse-merge library, built at first use; None if unavailable
    (the callers then take the numpy path)."""
    return _load("sparse_merge", _configure_merge)
