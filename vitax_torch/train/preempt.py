"""Preemption-safe shutdown (vitax/train/preempt.py): SIGTERM -> a
committed checkpoint -> exit 0.

The handler only sets a flag; the train loop reads it through the control
plane (train/control.py) at the next step boundary, takes a waited save of
the live state mid-epoch (the sidecar records the steps done) and returns,
so --resume_epoch -1 re-enters the epoch at the next step. Keeping the
handler to a flag keeps it async-signal-safe and the save on the loop
thread, where the card's state is.
"""

from __future__ import annotations

import signal
import threading

_REQUESTED = threading.Event()
_INSTALLED = False
_PREV_HANDLER = None


def _handler(signum, frame):  # noqa: ARG001 - signal handler signature
    _REQUESTED.set()


def install() -> bool:
    """Install the SIGTERM handler (idempotent). False off the main thread,
    where signal.signal raises (a pytest-xdist worker, a thread that calls
    train()): the preemption save is then unavailable, never fatal."""
    global _INSTALLED, _PREV_HANDLER
    if _INSTALLED:
        return True
    try:
        _PREV_HANDLER = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return False
    # a SIGTERM that reached an earlier train() after it stopped polling
    # must not preempt this run at its first step
    _REQUESTED.clear()
    _INSTALLED = True
    return True


def uninstall() -> None:
    """Put back the SIGTERM disposition install() replaced (idempotent);
    train() calls it on the way out, so later work keeps normal SIGTERM."""
    global _INSTALLED, _PREV_HANDLER
    if not _INSTALLED:
        return
    try:
        signal.signal(signal.SIGTERM, _PREV_HANDLER if _PREV_HANDLER is not None else signal.SIG_DFL)
    except ValueError:
        pass  # not the main thread: leave it
    _INSTALLED = False
    _PREV_HANDLER = None


def requested() -> bool:
    """True once SIGTERM has arrived (sticky until reset())."""
    return _REQUESTED.is_set()


def reset() -> None:
    """Clear the flag (tests; a supervisor that decides to go on)."""
    _REQUESTED.clear()
