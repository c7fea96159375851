"""Multi-session streaming replay through the router's HTTP front door.

The port's own copy of ``RouterStreamOutcome``, ``RouterTrafficReport``
and ``RouterTraffic`` from the repository's ``tests/sim/traffic.py`` (the
package imports nothing from ``tests/``): the same seeded request list, the
same client-side verdicts.  ``models/benchmark.py``'s router-side phases
and ``chip_smoke.py`` drive their routers with it.  Stdlib only.
"""

from __future__ import annotations

import random
import threading
import time


class RouterStreamOutcome:
    """One streamed request's client-side verdict."""

    __slots__ = (
        "prompt", "max_new", "tokens", "completed", "dropped", "cancelled",
        "reason", "ttft_s", "session", "rid",
    )

    def __init__(self, prompt, max_new, session, rid=""):
        self.prompt = prompt
        self.max_new = max_new
        self.session = session
        # Client-chosen X-Request-Id: the grep/join key tying this
        # stream's verdict to router + replica spans and flight events
        # (the trace-completeness scorer joins on it).
        self.rid = rid
        self.tokens: list = []
        self.completed = False
        self.dropped = False
        self.cancelled = False
        self.reason = ""
        self.ttft_s = None


class RouterTrafficReport:
    """Aggregate client-side truth for one router replay: the zero-drop
    contract is judged HERE, from what clients actually saw — not from
    any router counter."""

    def __init__(self):
        self.outcomes: list[RouterStreamOutcome] = []
        self.duration_s = 0.0

    @property
    def submitted(self) -> int:
        return len(self.outcomes)

    @property
    def completed(self) -> int:
        return sum(1 for o in self.outcomes if o.completed)

    @property
    def dropped(self) -> int:
        return sum(1 for o in self.outcomes if o.dropped)

    @property
    def cancelled(self) -> int:
        return sum(1 for o in self.outcomes if o.cancelled)

    @property
    def tokens(self) -> int:
        return sum(len(o.tokens) for o in self.outcomes)

    def ttfts(self) -> list[float]:
        return sorted(
            o.ttft_s for o in self.outcomes if o.ttft_s is not None
        )

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "dropped": self.dropped,
            "cancelled": self.cancelled,
            "tokens": self.tokens,
            "drop_reasons": sorted(
                {o.reason for o in self.outcomes if o.dropped}
            ),
            "duration_s": round(self.duration_s, 3),
        }


class RouterTraffic:
    """Multi-session production-shaped replay through the router's HTTP
    front door (streaming SSE clients over real sockets).

    The load shape affinity needs to be measurable: ``sessions``
    long-lived "tenants" each reuse one shared system-prompt prefix
    (``prefix_len`` tokens) with a short unique suffix per request —
    the repeated-prefix workload the KV tiers + prefix-affinity routing
    exist for.  Deterministic per seed: the same seed replays the exact
    same request sequence (the affinity-vs-random benchmark control
    rides on this).

    ``expected_fn(prompt, max_new) -> [tokens]``, when given, verifies
    every completed stream token-for-token (the FakeReplica oracle) —
    a failover that corrupted a stream counts as dropped.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        seed: int = 0,
        sessions: int = 6,
        prefix_len: int = 32,
        vocab: int = 32000,
        expected_fn=None,
        shared_prefix_len: int = 0,
    ):
        self.host = host
        self.port = port
        self.vocab = vocab
        self.expected_fn = expected_fn
        rng = random.Random(seed * 7919 + 13)
        # ``shared_prefix_len`` leading tokens common to EVERY session
        # (the fleet-wide system prompt the KV fabric deduplicates);
        # the rest of each session's prefix stays session-unique so
        # affinity still scatters sessions across replicas.
        shared = [rng.randrange(2, vocab) for _ in range(shared_prefix_len)]
        self.prefixes = [
            shared
            + [
                rng.randrange(2, vocab)
                for _ in range(max(0, prefix_len - shared_prefix_len))
            ]
            for _ in range(sessions)
        ]
        self.seed = seed

    def build_requests(
        self,
        n_requests: int,
        *,
        suffix_len: tuple[int, int] = (1, 6),
        max_new: tuple[int, int] = (4, 10),
        cancel_fraction: float = 0.0,
    ) -> list[tuple[list[int], int, int, bool]]:
        """The deterministic request list: (prompt, max_new, session,
        cancel_after_first_token)."""
        rng = random.Random(self.seed)
        out = []
        for _ in range(n_requests):
            session = rng.randrange(len(self.prefixes))
            suffix = [
                rng.randrange(2, self.vocab)
                for _ in range(rng.randint(*suffix_len))
            ]
            out.append((
                self.prefixes[session] + suffix,
                rng.randint(*max_new),
                session,
                rng.random() < cancel_fraction,
            ))
        return out

    def _stream_one(
        self, prompt, n_new: int, session: int, cancel: bool,
        timeout_s: float, rid: str = "",
    ) -> RouterStreamOutcome:
        import http.client
        import json as json_mod

        outcome = RouterStreamOutcome(prompt, n_new, session, rid=rid)
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=timeout_s
        )
        t0 = time.monotonic()
        try:
            headers = {"Content-Type": "application/json"}
            if rid:
                headers["X-Request-Id"] = rid
            conn.request(
                "POST",
                "/generate",
                json_mod.dumps(
                    {"prompt": prompt, "max_new_tokens": n_new,
                     "stream": True}
                ).encode(),
                headers=headers,
            )
            resp = conn.getresponse()
            if resp.status != 200:
                outcome.dropped = True
                outcome.reason = f"HTTP {resp.status}"
                return outcome
            while True:
                line = resp.readline()
                if not line:
                    outcome.dropped = True
                    outcome.reason = "EOF before done"
                    return outcome
                line = line.strip()
                if not line or line.startswith(b":"):
                    continue
                if not line.startswith(b"data:"):
                    continue
                event = json_mod.loads(line[5:].strip())
                if "token" in event:
                    if outcome.ttft_s is None:
                        outcome.ttft_s = time.monotonic() - t0
                    outcome.tokens.append(event["token"])
                    if cancel:
                        # Client vanishes mid-stream (the router must
                        # cancel upstream, not leak the decode).
                        outcome.cancelled = True
                        return outcome
                    continue
                if event.get("done"):
                    outcome.tokens = list(event.get("tokens", outcome.tokens))
                    outcome.completed = True
                    if self.expected_fn is not None:
                        want = self.expected_fn(prompt, n_new)
                        if outcome.tokens != want:
                            outcome.completed = False
                            outcome.dropped = True
                            outcome.reason = "token mismatch"
                    return outcome
                if "error" in event:
                    outcome.dropped = True
                    outcome.reason = str(event["error"])
                    return outcome
        except OSError as e:
            outcome.dropped = True
            outcome.reason = f"transport: {e}"
            return outcome
        finally:
            conn.close()

    def run(
        self,
        n_requests: int,
        *,
        concurrency: int = 8,
        suffix_len: tuple[int, int] = (1, 6),
        max_new: tuple[int, int] = (4, 10),
        cancel_fraction: float = 0.0,
        gap_s: float = 0.0,
        timeout_s: float = 60.0,
    ) -> RouterTrafficReport:
        """Replay ``n_requests`` streaming requests over ``concurrency``
        client threads; blocks until every stream resolves."""
        requests = self.build_requests(
            n_requests,
            suffix_len=suffix_len,
            max_new=max_new,
            cancel_fraction=cancel_fraction,
        )
        report = RouterTrafficReport()
        lock = threading.Lock()
        index = [0]
        t0 = time.monotonic()

        def worker():
            while True:
                with lock:
                    if index[0] >= len(requests):
                        return
                    i = index[0]
                    index[0] += 1
                prompt, n_new, session, cancel = requests[i]
                outcome = self._stream_one(
                    prompt, n_new, session, cancel, timeout_s,
                    rid=f"traffic-{self.seed}-{i}",
                )
                with lock:
                    report.outcomes.append(outcome)
                if gap_s:
                    time.sleep(gap_s)

        threads = [
            threading.Thread(
                target=worker, name=f"router-client-{i}", daemon=True
            )
            for i in range(concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s + 30)
        report.duration_s = time.monotonic() - t0
        return report

    def run_in_thread(self, n_requests: int, **kwargs):
        """Background replay for fault-injection scenarios; returns
        (thread, holder) with holder[0] the report after join."""
        holder: list = [None]

        def _run():
            holder[0] = self.run(n_requests, **kwargs)

        t = threading.Thread(target=_run, name="router-traffic", daemon=True)
        t.start()
        return t, holder
