"""Prometheus-format counters, gauges and histograms, stdlib-only.

The port's own copy of the registry the serving engine's ``EngineMetrics``
needs (the reference keeps the same machinery in its ``utils/metrics.py``);
the exposition text is the same 0.0.4 format, so a scrape of either engine
reads alike.  The HTTP exporter is not part of this slice.
"""

from __future__ import annotations

import bisect
import threading
import time
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


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)


class _Timer:
    """Context manager observing elapsed wall seconds into a histogram."""

    def __init__(self, observe):
        self._observe = observe

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._observe(time.monotonic() - self._t0)
        return False


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` exposition) with the
    PromQL-style ``quantile`` estimate the batch CLI reports."""

    TYPE = "histogram"
    # Log-spaced seconds, 1ms..10s.
    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help_text: str, buckets=None):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._count += 1
            self._sum += v

    def time(self) -> _Timer:
        return _Timer(self.observe)

    def snapshot(self) -> tuple[tuple[int, ...], int, float]:
        """(bucket_counts, count, sum) now — the ``since`` anchor for
        :meth:`quantile`, so warmup observations can be subtracted."""
        with self._lock:
            return tuple(self._bucket_counts), self._count, self._sum

    def quantile(self, q: float, since=None) -> float | None:
        """The q-quantile as PromQL's histogram_quantile() estimates it:
        the bucket where the cumulative count crosses q*total, linearly
        interpolated.  ``since`` (a prior :meth:`snapshot`) restricts the
        window.  None on an empty window; a crossing in +Inf reports the
        highest finite bound."""
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
        for le, n, lower in zip(self.buckets, counts, (0.0,) + self.buckets[:-1]):
            cum += n
            if cum >= rank and n > 0:
                return lower + (le - lower) * (rank - (cum - n)) / n
        return self.buckets[-1]

    def collect(self) -> list[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.TYPE}"]
            cum = 0
            for le, n in zip(self.buckets, self._bucket_counts):
                cum += n
                lines.append(f'{self.name}_bucket{{le="{_format_value(le)}"}} {cum}')
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

    def counter(self, name: str, help_text: str, labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help_text, labelnames))

    def gauge(self, name: str, help_text: str, labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, labelnames))

    def histogram(self, name: str, help_text: str, buckets=None) -> Histogram:
        return self._register(Histogram(name, help_text, buckets))

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.collect())
        return "\n".join(lines) + "\n"
