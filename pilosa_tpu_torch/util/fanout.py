"""Bounded thread fan-out for multi-shard ingest; a copy of
``pilosa_tpu/util/fanout.py``.  ``Field.import_bulk`` and
``Field.import_values`` apply their per-fragment groups through it.

A bulk import spanning shards used to apply them serially; each
fragment has its own lock, so per-fragment applies are independent and
can run concurrently (numpy releases the GIL for the sort/merge heavy
lifting).  The executor here is ONE-SHOT per call, not a shared pool:
the import paths nest (API-level remote fan-out -> field-level
per-fragment fan-out), and nested waits on a single bounded pool
deadlock.  Thread spin-up is ~50 us — noise against a shard's worth of
import work.

``PILOSA_IMPORT_FANOUT`` caps the width (default 8; 0 or 1 = serial).
"""

from __future__ import annotations

import os

DEFAULT_IMPORT_FANOUT = 8


def fanout_width(n_tasks: int) -> int:
    """Width cap: the env value verbatim when set; otherwise
    min(DEFAULT, cpu_count) — oversubscribing threads past the cores
    measurably HURTS the import path (the python glue between the
    GIL-releasing numpy/native kernels thrashes under contention)."""
    env = os.environ.get("PILOSA_IMPORT_FANOUT")
    if env is not None:
        try:
            cap = int(env)
        except ValueError:
            cap = DEFAULT_IMPORT_FANOUT
    else:
        cap = min(DEFAULT_IMPORT_FANOUT, os.cpu_count() or 1)
    return max(1, min(cap, n_tasks))


def run_fanout(tasks):
    """Run thunks — concurrently when more than one and fan-out is
    enabled — returning results in task order.  All tasks are attempted;
    the first (task-order) exception re-raises after the rest finish,
    so a mid-batch failure can't leave half the fan-out silently
    unapplied without surfacing."""
    if not tasks:
        return []
    width = fanout_width(len(tasks))
    if width <= 1 or len(tasks) == 1:
        return [t() for t in tasks]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=width, thread_name_prefix="import-fanout"
    ) as pool:
        futs = [pool.submit(t) for t in tasks]
        results = []
        first_err = None
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_err is None:
                    first_err = e
                results.append(None)
        if first_err is not None:
            raise first_err
        return results
