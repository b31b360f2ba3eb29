"""Live telemetry for serving: /metrics endpoint, snapshots, SLO burn
(``bigdl_tpu/observability/live.py``).

Until now Prometheus was a dump-at-drain text file — a crashed server
lost every counter, and nothing could be scraped *while* traffic ran.
This module is the live half (BigDL leaned on Spark's live UI for
exactly this role; here it is three small stdlib pieces):

* :class:`LiveMetricsServer` — a ``http.server`` thread serving the
  existing Prometheus exposition text at ``GET /metrics`` (plus
  ``/healthz``), live, from any render callable.  Port 0 binds an
  ephemeral port (tests, multi-worker hosts); the bound address is on
  ``.url``.
* :class:`MetricsSnapshotter` — periodic on-disk ``.prom`` snapshots of
  the same text, so a crash loses at most one interval of counters
  instead of all of them.
* :class:`SLOTracker` — sliding-window deadline-hit-rate tracking.
  ``observe(ok, dur_s)`` per terminal request; when the **burn rate**
  (miss rate over the window divided by the error budget ``1-target``)
  crosses its threshold — or windowed p99 crosses an absolute bound —
  it ledgers an ``slo.burn`` event and fires an optional trigger
  callback (the serving layer uses it to flush a trace-export capture
  window), both rate-limited by a cooldown.

Everything here is fail-soft: a dead endpoint, a full disk or a broken
trigger callback must never take the serving path down.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Deque, Optional

import collections

from bigdl_tpu_torch.observability import ledger
# nearest-rank percentile shared with run-report (stdlib-only module;
# imported at module scope so the request-completion path never pays
# an import lookup)
from bigdl_tpu_torch.observability.report import _percentile

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def scrape(url: Optional[str], timeout: float = 5.0) -> Optional[str]:
    """GET a live /metrics endpoint; ``None`` on any failure — the
    drill and benches *assert* on the result, they must not crash on
    it."""
    if url is None:
        return None
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode("utf-8")
    except Exception:
        return None


class LiveMetricsServer:
    """Threaded HTTP endpoint serving ``render()`` at ``/metrics``.

    ``render`` is any zero-arg callable returning Prometheus exposition
    text (``metrics_to_prometheus(metrics)`` bound to a live ``Metrics``
    object is the intended one).  Binds immediately (so the port is
    known), serves from a daemon thread, and degrades to 500 on a
    render error instead of dying.
    """

    def __init__(self, render: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 0):
        self._render = render

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):                       # noqa: N802
                if self.path.split("?")[0] in ("/metrics", "/"):
                    try:
                        body = outer._render().encode("utf-8")
                    except Exception as e:
                        self.send_error(500, f"render failed: "
                                             f"{type(e).__name__}")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):               # scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bigdl-torch-live-metrics", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


class MetricsSnapshotter:
    """Write ``render()`` to ``path`` every ``interval_s`` seconds from
    a daemon thread; ``close()`` writes one final snapshot.  Write
    errors go dark after the first (same posture as the ledger's
    writer) — a dead disk must not spam or stall serving."""

    def __init__(self, render: Callable[[], str], path: str,
                 interval_s: float = 5.0):
        self._render = render
        self.path = path
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._failed = False
        self._thread = threading.Thread(
            target=self._loop, name="bigdl-torch-metrics-snapshot",
            daemon=True)
        self._thread.start()

    def _write(self) -> None:
        if self._failed:
            return
        try:
            # atomic publish: a scraper reading the snapshot mid-write sees
            # the previous one, never a torn mix.  Imported here: the
            # package's utils import torch, and the ledger's readers
            # (run-report, trace-export) must not pay for it
            from bigdl_tpu_torch.utils.durable_io import atomic_write_text
            atomic_write_text(self.path, self._render())
        except Exception:
            self._failed = True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def close(self) -> None:
        self._stop.set()
        self._write()


class SLOTracker:
    """Sliding-window SLO accounting over terminal request outcomes.

    ``target`` is the deadline-hit-rate objective (e.g. ``0.99`` = at
    most 1% of requests may miss); the **burn rate** is
    ``miss_rate / (1 - target)`` — burn 1.0 spends the error budget
    exactly as fast as allowed, >1.0 is an incident in the making
    (the standard multiwindow burn-alert quantity, reduced to one
    window).  ``observe`` returns the breach info dict when it fired,
    else ``None``.
    """

    def __init__(self, target: float = 0.99, window: int = 128,
                 min_samples: int = 16, burn_threshold: float = 1.0,
                 p99_threshold_s: Optional[float] = None,
                 cooldown_s: float = 5.0,
                 on_trigger: Optional[Callable[[dict], None]] = None):
        if not 0.0 < target < 1.0:
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        self.target = float(target)
        self.window = int(window)
        self.min_samples = max(1, int(min_samples))
        self.burn_threshold = float(burn_threshold)
        self.p99_threshold_s = p99_threshold_s
        self.cooldown_s = float(cooldown_s)
        self.on_trigger = on_trigger
        self._samples: Deque = collections.deque(maxlen=self.window)
        self._misses = 0               # running count over the window
        self._obs_count = 0            # p99 sampling cadence
        self._lock = threading.Lock()
        self._last_fire = -float("inf")
        self.burn_count = 0            # fired events (rate-limited)

    def observe(self, ok: bool, dur_s: float) -> Optional[dict]:
        with self._lock:
            # running miss counter (append + evict) so the common
            # nothing-fires path is O(1) — observe() sits on the
            # request-completion hot path under this lock
            if len(self._samples) == self._samples.maxlen and \
                    not self._samples[0][0]:
                self._misses -= 1
            self._samples.append((bool(ok), float(dur_s)))
            if not ok:
                self._misses += 1
            n = len(self._samples)
            misses = self._misses
            if n < self.min_samples:
                return None
            # cooldown gate FIRST: during a sustained burn the tracker
            # would otherwise sort the window per request only to
            # return None anyway
            now = time.monotonic()
            if now - self._last_fire < self.cooldown_s:
                return None
            burn = (misses / n) / max(1.0 - self.target, 1e-9)
            fired_burn = burn >= self.burn_threshold and misses > 0
            # the O(n log n) percentile runs only when a burn is
            # already firing, or — with an absolute p99 bound armed —
            # on a 1-in-16 sampling cadence, so the common path stays
            # O(1) under the lock that serializes request completion
            self._obs_count += 1
            if not fired_burn and (self.p99_threshold_s is None
                                   or self._obs_count % 16):
                return None
            p99 = _percentile(sorted(d for _, d in self._samples), 99)
            fired_p99 = (self.p99_threshold_s is not None
                         and p99 >= self.p99_threshold_s)
            if not (fired_burn or fired_p99):
                return None
            self._last_fire = now
            self.burn_count += 1
            info = {"burn": burn, "hit_rate": 1.0 - misses / n,
                    "target": self.target, "window": n,
                    "misses": misses, "p99_s": p99,
                    "reason": "burn_rate" if fired_burn else "p99",
                    "seq": self.burn_count}
        # outside the lock: ledger + trigger must not serialize serving
        ledger.emit_critical("slo.burn", **info)
        if self.on_trigger is not None:
            try:
                self.on_trigger(info)
            except Exception:
                pass                     # capture is best-effort
        return info

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._samples)
            misses = self._misses
        return {"target": self.target, "window": self.window,
                "samples": n, "misses": misses,
                "hit_rate": (1.0 - misses / n) if n else 1.0,
                "burn_rate": ((misses / n) / max(1.0 - self.target, 1e-9)
                              if n else 0.0),
                "burn_events": self.burn_count}
