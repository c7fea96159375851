"""Always-on per-step engine profiler: phase breakdown, occupancy, memory.

The port of the reference's ``models/engine_profiler.py``: the same
phases, windows, flight summaries and ``GET /debug/profile`` body; device
memory comes from ``torch.cuda.memory_allocated`` (and the peak from
``max_memory_allocated``) on the engine's card, and is None on the CPU.
The reference's text follows.

The step-time histogram (``tpu_engine_step_seconds``) says a step
got slow; it cannot say WHERE — admission scheduling, a long prefill
chunk, the jitted decode dispatch, host-side sample consumption, or a
speculative verify round.  This profiler times those phases on every
step (two ``perf_counter`` reads per phase — cheap enough to never turn
off), tracks batch occupancy, KV-page utilization, and device-memory
deltas, and keeps rolling windows so ``GET /debug/profile`` can answer
with p50/p99 per phase over the recent past.  The step-time/HBM
breakdown is the host-visible half of the profiling story
arXiv:2309.08918 motivates; the device-op half stays with
``POST /debug/profile/capture`` (a torch.profiler trace of a live step).

Every ``summary_every`` steps a compact aggregate goes into the flight
recorder (utils/flight.py) as an ``engine.step`` event — the black box
carries the performance timeline alongside the lifecycle events — and
each step's wall time feeds the anomaly monitor when one is wired.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

# Host-observable step phases, in execution order.  "schedule" covers
# admission + cancel sweeps, "prefill" the chunked prefill advance and
# graft/activation, "dispatch" the decode enqueue(s) (two per step when
# the overlapped pipeline primes the next step before the readback),
# "readback" the blocking device→host sync of the consumed step (in the
# synchronous loop this includes the device compute — the old "decode"
# phase), "sample" the host-side consumption when nothing is in flight,
# "host_gap" the same consumption when it overlaps the next step's
# device compute (the gap the accelerator used to idle through — a
# well-overlapped engine shows host_gap ≈ the old sample time with
# readback shrunk toward pure transfer), and "spec_verify" the whole
# speculative draft+verify round (which replaces all of the above on
# speculative engines).
PHASES = (
    "schedule", "prefill", "dispatch", "readback", "sample", "host_gap",
    "spec_verify",
)


class StepTimer:
    """Per-step phase stopwatch: ``mark(phase)`` attributes the time
    since the previous mark (or construction) to ``phase``.  One of
    these is created per engine step; it is owner-thread-only."""

    __slots__ = ("phases", "t0", "_t")

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.t0 = time.perf_counter()
        self._t = self.t0

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (now - self._t)
        self._t = now


def _percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted window."""
    if not sorted_values:
        return 0.0
    idx = min(int(q * len(sorted_values)), len(sorted_values) - 1)
    return sorted_values[idx]


class EngineProfiler:
    """Rolling-window per-step profile of one ServingEngine.

    ``window`` bounds host memory (one small dict per step).  ``flight``
    receives an ``engine.step`` aggregate every ``summary_every`` steps;
    ``observe_step`` (wired to the anomaly monitor) receives every
    step's wall seconds.  ``snapshot()`` is the JSON body of
    ``GET /debug/profile``; writers run on the engine owner thread,
    readers on HTTP handler threads — hence the lock.
    """

    def __init__(
        self,
        window: int = 256,
        flight=None,
        summary_every: int = 64,
        observe_step=None,
        device=None,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.flight = flight
        self.summary_every = max(int(summary_every), 1)
        self.observe_step = observe_step
        self._lock = threading.Lock()
        self._window: deque[dict] = deque(maxlen=window)
        self.steps = 0
        self.tokens = 0
        self._phase_totals = {p: 0.0 for p in PHASES}
        # The card whose memory is tracked (None: the first CUDA device
        # when there is one; a CPU device tracks nothing).
        self.device = device
        self._mem_fn = "unprobed"  # "unprobed" -> callable | None
        self._last_mem: Optional[int] = None
        self._peak_fn = None
        # Measured spans-enabled per-step overhead fraction (the
        # benchmark's A/B over the same jobs, spans off vs on); None
        # until a bench round noted one.  Rides the snapshot so
        # GET /debug/profile answers "what does tracing cost here".
        self._trace_overhead: Optional[float] = None

    def timer(self) -> StepTimer:
        return StepTimer()

    def note_trace_overhead(self, overhead: float) -> None:
        """Record the measured spans-on vs spans-off per-step overhead
        fraction (benchmark.py --model serving's tracing phase)."""
        self._trace_overhead = float(overhead)

    # -------------------------------------------------------------- memory

    def _memory_bytes(self) -> Optional[int]:
        """Bytes the caching allocator has handed out on the engine's card
        (``torch.cuda.memory_allocated``); None on the CPU — probed once,
        then either read every step or never again."""
        if self._mem_fn == "unprobed":
            self._mem_fn = None
            try:
                import torch

                dev = self.device
                if dev is None and torch.cuda.is_available():
                    dev = torch.device("cuda", torch.cuda.current_device())
                if dev is not None and torch.device(dev).type == "cuda":
                    self._mem_fn = lambda d=torch.device(dev): torch.cuda.memory_allocated(d)
                    self._peak_fn = lambda d=torch.device(dev): torch.cuda.max_memory_allocated(d)
            except Exception:
                self._mem_fn = None
        if self._mem_fn is None:
            return None
        try:
            return int(self._mem_fn())
        except Exception:
            self._mem_fn = None
            return None

    # --------------------------------------------------------------- record

    def finish_step(
        self,
        timer: StepTimer,
        *,
        active_slots: int,
        max_slots: int,
        queued: int,
        kv_page_utilization: float,
        tokens: int,
        overlap_hits: int = 0,
        overlap_discards: int = 0,
        kvcache_hits: int = 0,
        kvcache_restores: int = 0,
    ) -> float:
        """Close out one step: fold the timer into the windows, sample
        memory, emit the periodic flight summary, feed the anomaly hook.
        ``overlap_hits``/``overlap_discards`` are THIS step's deltas from
        the engine's overlapped-pipeline counters (a hit = the step was
        consumed from an in-flight dispatch; a discard = a wasted lane);
        ``kvcache_hits``/``kvcache_restores`` likewise from the KV
        tiering counters (pages served from a tier / restored
        host->device this step).  Returns the step's wall seconds."""
        now = time.perf_counter()
        wall = now - timer.t0
        mem = self._memory_bytes()
        record = {
            "wall_s": wall,
            "phases": timer.phases,
            "active_slots": active_slots,
            "queued": queued,
            "kv_page_utilization": kv_page_utilization,
            "tokens": tokens,
            "overlap_hits": overlap_hits,
            "overlap_discards": overlap_discards,
            "kvcache_hits": kvcache_hits,
            "kvcache_restores": kvcache_restores,
        }
        if mem is not None:
            record["mem_bytes"] = mem
            if self._last_mem is not None:
                record["mem_delta"] = mem - self._last_mem
            self._last_mem = mem
        with self._lock:
            self._window.append(record)
            self.steps += 1
            self.tokens += tokens
            for phase, dt in timer.phases.items():
                if phase in self._phase_totals:
                    self._phase_totals[phase] += dt
            emit_summary = (
                self.flight is not None and self.steps % self.summary_every == 0
            )
            if emit_summary:
                window = list(self._window)
        if emit_summary:
            walls = sorted(r["wall_s"] for r in window)
            self.flight.record(
                "engine.step",
                steps=self.steps,
                window=len(window),
                step_ms_p50=round(_percentile(walls, 0.5) * 1e3, 3),
                step_ms_p99=round(_percentile(walls, 0.99) * 1e3, 3),
                active_slots=active_slots,
                queued=queued,
                kv_page_utilization=round(kv_page_utilization, 4),
                tokens_per_step=round(
                    sum(r["tokens"] for r in window) / len(window), 2
                ),
                occupancy=round(
                    sum(r["active_slots"] for r in window)
                    / (len(window) * max(max_slots, 1)),
                    4,
                ),
                # Overlap health over the window: hit ratio near 1.0
                # means steady decode consumed almost every step from an
                # in-flight dispatch; a discard-heavy ratio says traffic
                # churns faster than the pipeline can stay primed.
                overlap_hit_ratio=round(
                    sum(r.get("overlap_hits", 0) for r in window)
                    / len(window),
                    4,
                ),
                overlap_discards=sum(
                    r.get("overlap_discards", 0) for r in window
                ),
                kvcache_hits=sum(r.get("kvcache_hits", 0) for r in window),
                kvcache_restores=sum(
                    r.get("kvcache_restores", 0) for r in window
                ),
            )
        if self.observe_step is not None:
            self.observe_step(wall)
        return wall

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON body for ``GET /debug/profile``: per-phase breakdown
        (mean/p50/p99 over the rolling window, lifetime totals), batch
        occupancy, KV-page utilization, and device-memory track."""
        with self._lock:
            window = list(self._window)
            steps = self.steps
            tokens = self.tokens
            totals = dict(self._phase_totals)
        n = len(window)
        phases = {}
        for phase in PHASES:
            samples = sorted(r["phases"].get(phase, 0.0) for r in window)
            in_window = [r for r in window if phase in r["phases"]]
            phases[phase] = {
                "total_s": round(totals[phase], 6),
                "window_mean_ms": round(
                    (sum(samples) / n * 1e3) if n else 0.0, 4
                ),
                "window_p50_ms": round(_percentile(samples, 0.5) * 1e3, 4),
                "window_p99_ms": round(_percentile(samples, 0.99) * 1e3, 4),
                "window_steps": len(in_window),
            }
        walls = sorted(r["wall_s"] for r in window)
        out = {
            "steps": steps,
            "tokens": tokens,
            "window": n,
            "trace_overhead": self._trace_overhead,
            "step_ms": {
                "mean": round((sum(walls) / n * 1e3) if n else 0.0, 4),
                "p50": round(_percentile(walls, 0.5) * 1e3, 4),
                "p99": round(_percentile(walls, 0.99) * 1e3, 4),
            },
            "phases": phases,
            "occupancy": {
                "mean_active_slots": round(
                    sum(r["active_slots"] for r in window) / n, 3
                )
                if n
                else 0.0,
                "mean_queued": round(sum(r["queued"] for r in window) / n, 3)
                if n
                else 0.0,
                "mean_kv_page_utilization": round(
                    sum(r["kv_page_utilization"] for r in window) / n, 4
                )
                if n
                else 0.0,
            },
            "tokens_per_step_mean": round(
                sum(r["tokens"] for r in window) / n, 3
            )
            if n
            else 0.0,
            "overlap": {
                "window_hits": sum(
                    r.get("overlap_hits", 0) for r in window
                ),
                "window_discards": sum(
                    r.get("overlap_discards", 0) for r in window
                ),
                "hit_ratio": round(
                    sum(r.get("overlap_hits", 0) for r in window) / n, 4
                )
                if n
                else 0.0,
            },
            "kvcache": {
                "window_hits": sum(r.get("kvcache_hits", 0) for r in window),
                "window_restores": sum(
                    r.get("kvcache_restores", 0) for r in window
                ),
            },
        }
        mems = [r["mem_bytes"] for r in window if "mem_bytes" in r]
        if mems:
            deltas = [r.get("mem_delta", 0) for r in window if "mem_delta" in r]
            out["device_memory"] = {
                "bytes_in_use": mems[-1],
                "window_min": min(mems),
                "window_max": max(mems),
                "delta_per_step_mean": round(
                    sum(deltas) / len(deltas), 1
                )
                if deltas
                else 0.0,
            }
            if self._peak_fn is not None:
                out["device_memory"]["peak_bytes"] = int(self._peak_fn())
        else:
            out["device_memory"] = None
        return out
