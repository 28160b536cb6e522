"""Request deadlines: the budget every request carries through the stack.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/deadline.py``. A
request's deadline comes from the ``X-SHAI-Deadline-Ms`` header, or the
unit's ``DEADLINE_MS`` env default, and rides a contextvar from the event
loop onto the model lane thread (``serve.app`` copies the context). The
engine checks it every step and finishes an expired request with stop
reason ``"timeout"``; the serving layer maps that to a 504.

A deadline is an absolute ``time.monotonic()`` instant, valid only within
this process: the header carries a duration, never an instant, so clock
skew between client and pod cannot corrupt it.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import time
from typing import Dict, Optional

#: request header naming the total budget in milliseconds
DEADLINE_HEADER = "x-shai-deadline-ms"

#: clamp: a deadline longer than this is a client bug, not a budget
MAX_DEADLINE_MS = 24 * 3600 * 1000


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute monotonic instant by which the request must be terminal."""

    at: float  # time.monotonic() instant

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1e3)

    @property
    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining_s <= 0.0


_current: "contextvars.ContextVar[Optional[Deadline]]" = (
    contextvars.ContextVar("shai_deadline", default=None))


def set_current_deadline(dl: Optional[Deadline]) -> "contextvars.Token":
    """Install the request's deadline on the context; returns the reset
    token (the serving layer resets it after the handler, so a keep-alive
    connection's next request cannot inherit a stale budget)."""
    return _current.set(dl)


def reset_current_deadline(token: "contextvars.Token") -> None:
    _current.reset(token)


def current_deadline() -> Optional[Deadline]:
    return _current.get()


def deadline_from_headers(headers: Dict[str, str],
                          default_ms: float = 0.0) -> Optional[Deadline]:
    """Resolve a request's deadline: header wins, env default fills in,
    0/absent means no deadline. Raises ``ValueError`` on a malformed or
    non-positive header (a client error, mapped to a 400)."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:
        return Deadline.after_ms(default_ms) if default_ms > 0 else None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(
            f"{DEADLINE_HEADER} must be a number of milliseconds, "
            f"got {raw!r}")
    # isfinite: 'nan' passes both `<= 0` and `min()` (every NaN comparison
    # is False) and would mint a deadline that never expires in the engine
    if not math.isfinite(ms) or ms <= 0:
        raise ValueError(f"{DEADLINE_HEADER} must be a finite number > 0, "
                         f"got {raw!r}")
    return Deadline.after_ms(min(ms, MAX_DEADLINE_MS))
