"""Rotation-safe incremental journal tailer.

The scraper follows every rank's event journal live, but
``BFTPU_JOURNAL_MAX_MB`` rotation swaps the file out from under a
naive tailer: :meth:`Registry.journal` closes the live file,
``os.replace``\\ s it to ``<path>.1`` and reopens a fresh ``<path>``.
A tailer that only tracks a byte offset then either re-reads the new
file from its stale offset (dropping everything before it) or rewinds
to zero (double-counting what it already consumed from the old
generation).

:class:`JournalTailer` tracks ``(st_ino, offset)`` instead.  On each
poll it stats the live path; when the inode changed, the bytes it was
tailing now live at ``<path>.1`` (that is the *same* inode — rename
does not copy), so it drains the remainder of the rotated file from
the saved offset first, then switches to the new live file at offset
0.  Exactly-once within each generation is preserved because a torn
final line (a writer mid-append) is buffered, not parsed, until its
newline arrives — and after a rotation the held fragment is completed
from the rotated generation, never glued onto the new file's first
line.

Only one rotated generation exists by design (the registry keeps
``.1`` only), so a tailer that polls at the scrape cadence can lose
records only if a rank writes a full ``BFTPU_JOURNAL_MAX_MB`` *twice*
between polls — at which point the journals themselves have dropped
that history too.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

__all__ = ["JournalTailer"]


class JournalTailer:
    """Incrementally yield parsed events from one rank's journal,
    surviving ``.1`` rotation without double-counting or dropping."""

    def __init__(self, path: str):
        self.path = path
        self._ino: Optional[int] = None
        self._offset = 0
        self._carry = b""
        self.events_read = 0
        self.bad_lines = 0
        self.rotations = 0

    # -- internals --------------------------------------------------------

    def _read_from(self, path: str, offset: int) -> Tuple[bytes, int]:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read()
        except OSError:
            return b"", offset
        return data, offset + len(data)

    def _parse(self, data: bytes, final: bool) -> List[dict]:
        """Split ``carry + data`` on newlines; an unterminated tail is
        carried unless ``final`` (end of a rotated generation, where the
        writer is gone and the fragment is all there will ever be)."""
        buf = self._carry + data
        if final:
            chunks, self._carry = buf.split(b"\n"), b""
        else:
            chunks = buf.split(b"\n")
            self._carry = chunks.pop()
        out: List[dict] = []
        for line in chunks:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self.bad_lines += 1
                continue
            if isinstance(ev, dict):
                out.append(ev)
            else:
                self.bad_lines += 1
        self.events_read += len(out)
        return out

    # -- API --------------------------------------------------------------

    def poll(self) -> List[dict]:
        """All events appended since the last poll, across at most one
        rotation flip."""
        out: List[dict] = []
        try:
            st = os.stat(self.path)
        except OSError:
            return out  # not created yet (or already reaped)
        if self._ino is None:
            self._ino = st.st_ino
        elif st.st_ino != self._ino:
            # The file we were tailing was renamed to <path>.1 and a
            # fresh live file took its place: drain the old generation
            # from our saved offset, then restart on the new inode.
            self.rotations += 1
            data, _ = self._read_from(self.path + ".1", self._offset)
            out.extend(self._parse(data, final=True))
            self._ino = st.st_ino
            self._offset = 0
        data, self._offset = self._read_from(self.path, self._offset)
        out.extend(self._parse(data, final=False))
        return out

    def drain(self) -> List[dict]:
        """Final poll that also flushes a trailing unterminated line
        (teardown: the writers have exited, nothing more is coming)."""
        out = self.poll()
        if self._carry:
            out.extend(self._parse(b"", final=True))
        return out
