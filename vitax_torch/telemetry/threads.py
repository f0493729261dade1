"""Background-thread crash visibility and bounded shutdown joins
(vitax/telemetry/threads.py).

- `install_thread_excepthook(recorder, rank)` routes every uncaught
  background-thread exception through one `threading.excepthook` (until
  `restore_thread_excepthook` puts the previous one back): a
  rank-tagged traceback on stderr, and a `kind: "thread_crash"` event
  where a Recorder is attached (the `thread_crashes` count of
  tools/metrics_report.py --json). SystemExit keeps its stdlib meaning.
- `report_thread_exception(exc)` hands the same hook an exception that a
  worker caught in order to pass it on (the loader's producer, the
  checkpoint writer), once per exception object; `reporting(fn)` tags an
  exception of a decode pool's worker with that thread, for the producer
  that reads the pool's future to report under its name.
- `join_or_warn(thread, timeout)` bounds a shutdown join: a wedged worker
  gets `timeout` seconds, then a loud warning instead of a blocked exit.
"""

from __future__ import annotations

import functools
import sys
import threading
import traceback
from typing import Callable, Optional

_state_lock = threading.Lock()
_crash_count = 0
_recorder = None
_rank = 0


def install_thread_excepthook(recorder=None, rank: int = 0) -> tuple:
    """Make the crash hook threading.excepthook and bind `recorder` and
    `rank` to it (the loop installs it early with no recorder, then again
    with one). Returns what it replaced, for restore_thread_excepthook."""
    global _recorder, _rank
    with _state_lock:
        previous = (threading.excepthook, _recorder, _rank)
        _recorder, _rank = recorder, int(rank)
    threading.excepthook = _excepthook
    return previous


def restore_thread_excepthook(previous: tuple) -> None:
    """Put back what install_thread_excepthook replaced: train() does at
    its end, so its closed recorder gets no events and the process's own
    hook comes back."""
    global _recorder, _rank
    hook, recorder, rank = previous
    with _state_lock:
        _recorder, _rank = recorder, rank
    threading.excepthook = hook


def thread_crash_count() -> int:
    """Uncaught background-thread exceptions seen since install."""
    with _state_lock:
        return _crash_count


def _excepthook(args) -> None:
    global _crash_count
    if args.exc_type is SystemExit:
        return                              # a deliberate thread exit, as the default hook treats it
    with _state_lock:
        _crash_count += 1
        recorder, rank = _recorder, _rank
    name = args.thread.name if args.thread is not None else "unknown"
    tb = "".join(traceback.format_exception(args.exc_type, args.exc_value, args.exc_traceback))
    print(f"[vitax_torch.threads rank {rank}] uncaught exception in background thread `{name}`:\n{tb}",
          file=sys.stderr, flush=True)
    if recorder is not None:
        try:                                # JSONL sinks flush per record: the event outlives a dying run
            recorder.event("thread_crash", rank=rank, thread=name,
                           error=f"{args.exc_type.__name__}: {args.exc_value}")
        except Exception as e:  # noqa: BLE001 - a broken sink must not recurse
            print(f"[vitax_torch.threads rank {rank}] thread_crash event sink failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)


def report_thread_exception(exc: BaseException) -> None:
    """Pass `exc`, caught on the current thread to be handed on, to
    threading.excepthook as if it had ended its thread: the pool worker it
    was raised on where `reporting` tagged one, else the current thread.
    Once per exception object, however many threads hand it on."""
    if getattr(exc, "_vitax_thread_reported", False):
        return
    try:
        exc._vitax_thread_reported = True
    except AttributeError:                  # an exception type without a __dict__
        pass
    thread = getattr(exc, "_vitax_thread", None) or threading.current_thread()
    threading.excepthook(threading.ExceptHookArgs((type(exc), exc, exc.__traceback__, thread)))


def reporting(fn: Callable) -> Callable:
    """`fn` for a pool: an exception it raises is tagged with the worker
    thread it ended on, then raised as before into the pool's future; the
    caller that reads the future reports it (report_thread_exception) under
    that worker's name. A failed map reports its first failure only."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if getattr(e, "_vitax_thread", None) is None:
                try:
                    e._vitax_thread = threading.current_thread()
                except AttributeError:
                    pass
            raise
    return wrapped


def join_or_warn(thread: Optional[threading.Thread], timeout: float, what: Optional[str] = None,
                 rank: int = 0) -> bool:
    """Join `thread` for at most `timeout` seconds. True when it is gone;
    on timeout a loud leaked-thread warning on stderr and False, so a
    shutdown path keeps going instead of hanging."""
    if thread is None or not thread.is_alive():
        return True
    thread.join(timeout=timeout)
    if thread.is_alive():
        print(f"[vitax_torch.threads rank {rank}] thread `{what or thread.name}` still alive {timeout:.0f}s "
              f"after shutdown was requested; leaking it rather than blocking process exit",
              file=sys.stderr, flush=True)
        return False
    return True
