"""WinHandle — the future returned by the async window ops.

A handle moves through exactly three states::

    PENDING --_complete(result)--> DONE(result)
    PENDING --_fail(exc)---------> DONE(exc)

and never leaves DONE: completing (or failing) a handle twice raises,
which is the lifecycle invariant the ``progress.handle-lifecycle``
verifier rule checks.  Handles are plain condition-free futures — one
``threading.Event`` each — because exactly one thread (the engine
worker, or the submitting thread in the engine-off synchronous
fallback) ever resolves them.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class WinHandle:
    """Completion future for one submitted async window op.

    ``wait(timeout)`` returns whether the op finished; ``result()``
    blocks then returns the op's value (``True`` for deposits, the
    combined tensor/pytree for ``win_update_async``) or re-raises the
    op's failure; ``done()`` never blocks.
    """

    __slots__ = ("_ev", "_result", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None

    # -- consumer side --------------------------------------------------

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("window op still in flight")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None) \
            -> Optional[BaseException]:
        if not self._ev.wait(timeout):
            raise TimeoutError("window op still in flight")
        return self._exc

    # -- engine side ----------------------------------------------------

    def _complete(self, result: Any) -> None:
        if self._ev.is_set():
            raise RuntimeError("WinHandle resolved twice")
        self._result = result
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        if self._ev.is_set():
            raise RuntimeError("WinHandle resolved twice")
        self._exc = exc
        self._ev.set()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if not self._ev.is_set():
            state = "pending"
        elif self._exc is not None:
            state = f"failed({type(self._exc).__name__})"
        else:
            state = "done"
        return f"<WinHandle {state}>"


def completed(result: Any) -> "WinHandle":
    """An already-resolved handle — the engine-off synchronous fallback
    (``BFTPU_PROGRESS=0``) and the SPMD-emulation parity wrappers return
    these so callers can use one API shape everywhere."""
    h = WinHandle()
    h._complete(result)
    return h
