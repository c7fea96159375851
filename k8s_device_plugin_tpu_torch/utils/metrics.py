"""Prometheus-format metrics, stdlib-only.

The port's own copy of the reference's ``utils/metrics.py`` (counters,
gauges, summaries, histograms, the registry and the 0.0.4 text
exposition), so a scrape of either engine reads alike and
``tools/metrics_lint.py`` holds both.  The stand-alone ``MetricsServer``
serves the GPU device plugin's ``/metrics`` and ``/debug/*``; the port's
HTTP server serves its own.

Exposition format: https://prometheus.io/docs/instrumenting/exposition_formats/
(text version 0.0.4) — `# HELP` / `# TYPE` headers, one `name{labels} value`
line per labeled series.
"""

from __future__ import annotations

import bisect
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Mapping


def _escape_label_value(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _format_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _format_value(value: float) -> str:
    # Integers render without a trailing ".0" (matches common exporters).
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class _Metric:
    TYPE = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], float] = {}

    def _key(self, labels: Mapping[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, want {sorted(self.labelnames)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.TYPE}"]
        with self._lock:
            if not self._series:
                return lines if self.labelnames else lines + [f"{self.name} 0"]
            for key in sorted(self._series):
                labels = dict(zip(self.labelnames, key))
                lines.append(
                    f"{self.name}{_format_labels(labels)} "
                    f"{_format_value(self._series[key])}"
                )
        return lines


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def remove(self, **labels: str) -> None:
        """Drop one labeled series (a per-device gauge whose device was
        unplugged must stop exporting, not freeze at its last value)."""
        with self._lock:
            self._series.pop(self._key(labels), None)


class _Timer:
    """Context manager observing elapsed wall seconds into any metric
    with an ``observe(seconds)`` method (Summary, Histogram)."""

    def __init__(self, observe):
        self._observe = observe

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._observe(time.monotonic() - self._t0)
        return False


class Summary:
    """count + sum pair (enough for rate()/avg in PromQL; no quantiles)."""

    TYPE = "summary"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += float(value)

    def time(self) -> "_Timer":
        return _Timer(self.observe)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def collect(self) -> list[str]:
        with self._lock:
            return [
                f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.TYPE}",
                f"{self.name}_count {self._count}",
                f"{self.name}_sum {_format_value(self._sum)}",
            ]


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` exposition): what
    PromQL's histogram_quantile() needs for p50/p99 dashboards — the
    piece Summary (count+sum only) can't provide.

    ``labelnames`` (optional) makes it a labeled family: each distinct
    labelset owns its own bucket counts, exported as
    ``name_bucket{<labels>,le="..."}`` series the way prometheus_client
    renders them (the exposition linter checks cumulative buckets per
    non-le labelset).  Keep the label space SMALL and closed — a
    per-priority-class split, never a per-request/tenant one."""

    TYPE = "histogram"
    # Log-spaced seconds, 1ms..10s: covers local-chip decode steps
    # (~ms), relay-RTT steps (~100ms), and compile stalls (~s).
    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    )

    def __init__(
        self,
        name: str,
        help_text: str,
        buckets=None,
        labelnames: Iterable[str] = (),
    ):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0
        # Labeled series: labelset key -> [bucket_counts, count, sum].
        self._series: dict[tuple[str, ...], list] = {}

    def _key(self, labels: Mapping[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"want {sorted(self.labelnames)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def observe(self, value: float, **labels: str) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        if self.labelnames:
            key = self._key(labels)
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = [
                        [0] * len(self.buckets), 0, 0.0
                    ]
                if i < len(self.buckets):
                    series[0][i] += 1
                series[1] += 1
                series[2] += v
            return
        if labels:
            raise ValueError(f"{self.name} takes no labels")
        with self._lock:
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._count += 1
            self._sum += v

    def time(self) -> "_Timer":
        return _Timer(self.observe)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> tuple[tuple[int, ...], int, float]:
        """(bucket_counts, count, sum) at this instant — the ``since``
        anchor for :meth:`quantile`, so a benchmark can report the timed
        region's percentiles with warmup observations subtracted."""
        with self._lock:
            return tuple(self._bucket_counts), self._count, self._sum

    def quantile(self, q: float, since=None) -> float | None:
        """Estimate the q-quantile (0 <= q <= 1) the way PromQL's
        histogram_quantile() does: find the bucket where the cumulative
        count crosses q*total and interpolate linearly inside it.  With
        ``since`` (a prior :meth:`snapshot`), only observations recorded
        after that snapshot count.  Returns None on an empty window; a
        crossing in the +Inf bucket reports the highest finite bound
        (the same clamp PromQL applies)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        counts, total, _ = self.snapshot()
        if since is not None:
            prev_counts, prev_total, _ = since
            counts = tuple(c - p for c, p in zip(counts, prev_counts))
            total -= prev_total
        if total <= 0:
            return None
        rank = q * total
        cum = 0
        for le, n, lower in zip(
            self.buckets, counts, (0.0,) + self.buckets[:-1]
        ):
            cum += n
            if cum >= rank and n > 0:
                frac = (rank - (cum - n)) / n
                return lower + (le - lower) * frac
        return self.buckets[-1]

    def collect(self) -> list[str]:
        with self._lock:
            lines = [
                f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.TYPE}",
            ]
            if self.labelnames:
                for key in sorted(self._series):
                    counts, count, total = self._series[key]
                    labels = dict(zip(self.labelnames, key))
                    blob = _format_labels(labels)  # "{k=\"v\",...}"
                    inner = blob[1:-1]
                    cum = 0
                    for le, n in zip(self.buckets, counts):
                        cum += n
                        lines.append(
                            f"{self.name}_bucket{{{inner},"
                            f'le="{_format_value(le)}"}} {cum}'
                        )
                    lines.append(
                        f'{self.name}_bucket{{{inner},le="+Inf"}} {count}'
                    )
                    lines.append(
                        f"{self.name}_sum{blob} {_format_value(total)}"
                    )
                    lines.append(f"{self.name}_count{blob} {count}")
                return lines
            cum = 0
            for le, n in zip(self.buckets, self._bucket_counts):
                cum += n
                lines.append(
                    f'{self.name}_bucket{{le="{_format_value(le)}"}} {cum}'
                )
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._count}')
            lines.append(f"{self.name}_sum {_format_value(self._sum)}")
            lines.append(f"{self.name}_count {self._count}")
            return lines


class MetricsRegistry:
    """Holds metrics and renders the exposition text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str):
        """Look up an already-registered metric family by name (None
        when absent) — the get-or-create seam for hooks that may be
        constructed more than once against a process-wide registry."""
        with self._lock:
            return self._metrics.get(name)

    def counter(self, name: str, help_text: str, labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help_text, labelnames))

    def gauge(self, name: str, help_text: str, labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, labelnames))

    def summary(self, name: str, help_text: str) -> Summary:
        return self._register(Summary(name, help_text))

    def histogram(
        self,
        name: str,
        help_text: str,
        buckets=None,
        labelnames: Iterable[str] = (),
    ) -> Histogram:
        return self._register(
            Histogram(name, help_text, buckets, labelnames=labelnames)
        )

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.collect())
        return "\n".join(lines) + "\n"


# Prometheus text exposition 0.0.4 — the one place the scrape
# content-type lives.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def write_exposition(handler, registry: "MetricsRegistry") -> None:
    """Answer one GET /metrics on a BaseHTTPRequestHandler: render the
    registry and write a 200 text-exposition response.  Shared by the
    plugin's MetricsServer and the serving EngineServer so the two
    /metrics endpoints cannot drift in content-type or framing."""
    body = registry.render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", PROM_CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class MetricsServer:
    """Serves GET /metrics (exposition text) and GET /healthz on a daemon
    thread.  Port 0 picks a free port (tests); `.port` reports it.

    ``health`` is an optional callable consulted by /healthz: True (or no
    callable) ⇒ 200 "ok", False ⇒ 503 — so a liveness probe reflects the
    daemon's actual state, not just this HTTP thread's.

    ``debug`` maps extra GET paths (e.g. ``/debug/devices``) to
    callables returning a JSON-serializable snapshot — the plugin-side
    introspection companion to the serving engine's ``/debug/state``.
    A callable declaring at least one positional parameter receives the
    parsed query dict (``{name: [values]}``; e.g. the span endpoint's
    ``?rid=`` filter); a no-arg callable is called bare.  A snapshot
    callable that raises answers 500 with the error, never kills the
    metrics thread.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        host: str = "0.0.0.0",
        port: int = 9100,
        health=None,
        debug=None,
    ):
        import inspect as _inspect
        import json as _json
        import urllib.parse as _urlparse

        registry_ref = registry
        health_ref = health
        debug_ref = dict(debug or {})
        # Decided once at construction, not per request: which debug
        # callables want the query dict (any positional parameter).
        wants_query = set()
        for _path, _fn in debug_ref.items():
            try:
                if _inspect.signature(_fn).parameters:
                    wants_query.add(_path)
            except (TypeError, ValueError):
                pass  # builtins without signatures: call bare

        class Handler(BaseHTTPRequestHandler):
            def _json_reply(self, code: int, obj) -> None:
                body = _json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                if path in debug_ref:
                    try:
                        if path in wants_query:
                            query = _urlparse.parse_qs(
                                _urlparse.urlparse(self.path).query
                            )
                            snap = debug_ref[path](query)
                        else:
                            snap = debug_ref[path]()
                    except Exception as e:  # snapshot bug must not kill scrapes
                        self._json_reply(500, {"error": str(e)})
                        return
                    self._json_reply(200, snap)
                elif path == "/metrics":
                    write_exposition(self, registry_ref)
                elif path == "/healthz":
                    try:
                        healthy = health_ref is None or bool(health_ref())
                    except Exception:
                        healthy = False
                    body = b"ok\n" if healthy else b"unhealthy\n"
                    self.send_response(200 if healthy else 503)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):  # quiet: scrapes are frequent
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        assert self._thread is None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gpu-plugin-metrics", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
