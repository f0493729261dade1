"""Metric sinks (vitax/telemetry/sinks.py): where structured records go.

A sink is anything with `write(record: dict)` and `close()`; the Recorder
fans every record out to all of its sinks:

- `JsonlSink`: the always-on run log, one JSON object a line, flushed per
  record so a crash never loses the history written before it.
- `TensorBoardSink`: an optional scalar mirror through tensorboard's
  writer that needs no TensorFlow; `make_tensorboard_sink` returns None
  (with one warning) where the package is missing.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Optional


class JsonlSink:
    """Append-only JSONL log. Thread-safe: a crashing background thread
    writes its event while the train thread writes step records."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def write(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()                  # per record: a partial run stays readable

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


class TensorBoardSink:
    """Mirror the numeric fields of step records as scalars train/<key>."""

    _SKIP = frozenset({"schema", "step", "time", "kind", "rank"})    # bookkeeping, not curves

    def __init__(self, logdir: str):
        from tensorboard.summary import Writer
        self._writer = Writer(logdir)

    def write(self, record: dict) -> None:
        step = record.get("step")
        if step is None or record.get("kind"):          # events are JSONL-only
            return
        for key, val in record.items():
            if key in self._SKIP or isinstance(val, bool):
                continue
            if isinstance(val, (int, float)):
                self._writer.add_scalar(f"train/{key}", float(val), int(step))
        self._writer.flush()

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - close must never raise at interpreter exit
            pass


def make_tensorboard_sink(logdir: str) -> Optional[TensorBoardSink]:
    """TensorBoardSink, or None (one warning) where tensorboard is missing
    or refuses the logdir: the JSONL sink is the durable record either way."""
    try:
        return TensorBoardSink(logdir)
    except Exception as e:  # noqa: BLE001 - an optional sink degrades to none
        print(f"vitax_torch.telemetry: tensorboard sink disabled ({type(e).__name__}: {e})",
              file=sys.stderr, flush=True)
        return None
