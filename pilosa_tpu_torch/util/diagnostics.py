"""Diagnostics: periodic anonymized usage reporting.

Mirror of the reference's diagnostics collector (diagnostics.go:42-249):
gathers version, platform, schema shape, and runtime stats into a JSON
document and POSTs it to an endpoint on an interval.  Off unless enabled
(``metric.diagnostics``); the flush is best-effort and never raises.

A copy of ``pilosa_tpu/util/diagnostics.py``; the device fields come from
``torch.cuda`` (the cards this process sees), never from JAX.
"""

from __future__ import annotations

import json
import platform
import threading
import time
import uuid
from typing import Optional


DEFAULT_INTERVAL = 3600.0


class Diagnostics:
    def __init__(
        self,
        api=None,
        endpoint: str = "",
        interval: float = DEFAULT_INTERVAL,
        logger=None,
        version_url: str = "",
    ):
        self.api = api
        self.endpoint = endpoint
        self.interval = interval
        self.logger = logger
        self.host_id = uuid.uuid4().hex[:16]
        self.start_time = time.time()
        self._closing = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_report: Optional[dict] = None  # inspectable for tests
        # Upstream version check (diagnostics.go:102-150): version_url
        # serves {"version": "vX.Y.Z"}; a newer release logs a warning.
        self.version_url = version_url
        self.last_version = ""
        self.last_version_warning = ""

    # -- payload (diagnostics.go:180-249) ----------------------------------

    def collect(self) -> dict:
        doc = {
            "id": self.host_id,
            "version": self.api.version() if self.api else "",
            "os": platform.system(),
            "arch": platform.machine(),
            "pythonVersion": platform.python_version(),
            "uptimeSeconds": int(time.time() - self.start_time),
        }
        if self.api is not None:
            num_fields = 0
            field_types = set()
            time_quantum_used = False
            for idx_info in self.api.schema():
                for f in idx_info["fields"]:
                    num_fields += 1
                    field_types.add(f["options"]["type"])
                    if f["options"].get("timeQuantum"):
                        time_quantum_used = True
            doc.update(
                {
                    "numIndexes": len(self.api.schema()),
                    "numFields": num_fields,
                    "fieldTypes": sorted(field_types),
                    "timeQuantumEnabled": time_quantum_used,
                    "clusterSize": len(self.api.hosts()),
                }
            )
        try:
            import torch

            if torch.cuda.is_available():
                doc["numDevices"] = torch.cuda.device_count()
                doc["devicePlatform"] = "gpu"
                doc["deviceKind"] = torch.cuda.get_device_name(0)
            else:
                doc["numDevices"] = 1
                doc["devicePlatform"] = "cpu"
        except Exception:
            pass
        return doc

    def flush(self):
        """Collect and (when an endpoint is configured) POST; always
        stores the report locally."""
        doc = self.collect()
        self.last_report = doc
        if not self.endpoint:
            return
        try:
            from urllib.request import Request, urlopen

            req = Request(
                self.endpoint,
                data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"},
            )
            urlopen(req, timeout=10).read()
        except Exception as e:
            if self.logger:
                self.logger.debugf("diagnostics flush failed: %s", e)

    # -- version check (diagnostics.go CheckVersion :102-150) --------------

    @staticmethod
    def _version_segments(v: str):
        """'v1.2.3[-suffix]' -> [1, 2, 3] (diagnostics.go
        versionSegments); malformed strings yield [] (no comparison)."""
        v = v.lstrip("v").split("-")[0]
        parts = v.split(".")
        try:
            segs = [int(p) for p in parts]
        except ValueError:
            return []
        return (segs + [0, 0, 0])[:3]

    def check_version(self) -> str:
        """Fetch the latest released version and compare against the
        local one; returns (and logs) a warning string when upstream is
        newer, "" otherwise.  Never raises (best-effort, like the
        diagnostics flush)."""
        if not self.version_url:
            return ""
        try:
            from urllib.request import urlopen

            with urlopen(self.version_url, timeout=10) as resp:
                latest = json.loads(resp.read()).get("version", "")
        except Exception as e:
            if self.logger:
                self.logger.debugf("version check failed: %s", e)
            return ""
        if not latest or latest == self.last_version:
            return self.last_version_warning if latest else ""
        self.last_version = latest
        local = self.api.version() if self.api else ""
        warning = self._compare_version(local, latest)
        self.last_version_warning = warning
        if warning and self.logger:
            self.logger.printf("%s", warning)
        return warning

    @staticmethod
    def _compare_version(local: str, latest: str) -> str:
        """diagnostics.go compareVersion :135-150: major/minor/patch
        messages when upstream is ahead."""
        lv = Diagnostics._version_segments(local)
        rv = Diagnostics._version_segments(latest)
        if not lv or not rv:
            return ""
        if lv[0] < rv[0]:
            return (
                f"Warning: You are running version {local}. "
                f"A newer version ({latest}) is available"
            )
        if lv[1] < rv[1] and lv[0] == rv[0]:
            return (
                f"Warning: You are running version {local}. "
                f"The latest minor release is {latest}"
            )
        if lv[2] < rv[2] and lv[0] == rv[0] and lv[1] == rv[1]:
            return f"There is a new patch release available: {latest}"
        return ""

    # -- loop (server.go monitorDiagnostics :675) --------------------------

    def start(self):
        def loop():
            while not self._closing.wait(self.interval):
                self.flush()
                self.check_version()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._closing.set()
