"""Structured logging setup for the plugin daemon.

The port's own copy of the JAX package's ``utils/logging.py`` (the port
imports nothing of that package).

The reference logs through glog with leveled verbosity flags set on the
container command line (reference Dockerfile:25, main.go glog calls).  We emit
one structured line per event — either logfmt-ish text or JSON — on stderr,
which is what `kubectl logs` collects from a DaemonSet pod.
"""

from __future__ import annotations

import json
import logging
import sys
import time


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # Structured events (utils/spans.py emission, or any caller passing
        # ``extra={"event": {...}}``): merged into the line so one JSON
        # record carries the machine-readable fields alongside the message.
        # The fixed keys above win on collision — a span attr must not be
        # able to spoof the log level.
        event = getattr(record, "event", None)
        if isinstance(event, dict):
            entry = {**event, **entry}
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, separators=(",", ":"), default=str)


def setup_logging(level: str = "INFO", json_logs: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    if json_logs:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)-7s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
