"""Console logging: severity-tagged ring buffer + log file.

Equivalent of the reference's Con_Logf / console ring (src/common/console.c):
256-line ring, severity levels, every line mirrored to a log file whose path
comes from the `con_logpath` cvar.  Headless (no ImGui window) — the ring is
queryable for tests and the command system.
"""

from __future__ import annotations

import collections
import sys
import time
from enum import IntEnum
from typing import Deque, Optional, Tuple


class LogSev(IntEnum):
    Error = 0
    Warning = 1
    Info = 2
    Verbose = 3


_SEV_NAMES = {
    LogSev.Error: "ERROR",
    LogSev.Warning: "WARN ",
    LogSev.Info: "INFO ",
    LogSev.Verbose: "VERB ",
}

_RING_SIZE = 256


class Console:
    def __init__(self) -> None:
        self.ring: Deque[Tuple[LogSev, str, str]] = collections.deque(maxlen=_RING_SIZE)
        self.log_path: Optional[str] = None
        self._file = None
        self.min_sev = LogSev.Info  # filter for stdout only; ring keeps all

    def set_log_path(self, path: Optional[str]) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        self.log_path = path
        if path:
            self._file = open(path, "a", buffering=1)

    def logf(self, sev: LogSev, tag: str, fmt: str, *args) -> None:
        msg = (fmt % args) if args else fmt
        self.ring.append((sev, tag, msg))
        line = f"[{_SEV_NAMES[sev]}][{tag}] {msg}"
        if sev <= self.min_sev:
            stream = sys.stderr if sev == LogSev.Error else sys.stdout
            print(line, file=stream)
        if self._file is not None:
            stamp = time.strftime("%H:%M:%S")
            self._file.write(f"{stamp} {line}\n")

    def clear(self) -> None:
        self.ring.clear()

    def lines(self):
        return list(self.ring)


_console = Console()


def get_console() -> Console:
    return _console


def con_logf(sev: LogSev, tag: str, fmt: str, *args) -> None:
    _console.logf(sev, tag, fmt, *args)


def con_exec(cmd_text: str) -> None:
    """Forward console input to the command system (lazy import)."""
    from pim.core import cmd as cmd_mod

    cmd_mod.cmd_enqueue(cmd_text)
