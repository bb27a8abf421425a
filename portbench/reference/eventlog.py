"""Event-log codec.

The reference uses the *root logging module* writing
``logs/simulation.log`` as the data channel between the DES and the music
decoders (simulation_v3.py:332-341, 546, 604, 617). The machine-readable
('Music' mode) lines are exactly::

    INFO:root:<time> - <event id> - <server id> - arrival
    INFO:root:<service time> - <event id> - <server id> - processing
    INFO:root:<time> - <event id> - <server id> - departure

where the floats are rendered with Python ``str()`` (shortest repr). We keep
this line format byte-for-byte, but buffer lines in memory and write the file
once per run: the log is only ever consumed after the run completes, and
skipping the logging module removes its per-record overhead from the DES hot
loop. ``EventLog.lines`` doubles as the in-memory fast path so decoders can
skip file I/O entirely.
"""

from __future__ import annotations

import os

LOG_PREFIX = "INFO:root:"


class EventLog:
    """Buffered writer producing reference-identical log files."""

    __slots__ = ("lines", "path")

    def __init__(self, path: str | None = None):
        self.lines: list[str] = []
        self.path = path

    def info(self, msg: str) -> None:
        self.lines.append(LOG_PREFIX + msg)

    def clear(self) -> None:
        self.lines.clear()

    def flush(self) -> None:
        """Write the buffered lines to ``self.path`` (truncating), matching
        the file the reference's ``logging.basicConfig(filemode='w')`` +
        ``logging.shutdown()`` sequence leaves behind."""
        if self.path is None:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "w") as f:
            if self.lines:
                f.write("\n".join(self.lines))
                f.write("\n")
