"""Quake-style console command system: registry, tokenizer, deferred queue.

Re-implements the reference's cmd tier (src/common/cmd.h:17-37, cmd.c):
- a registry of named commands with help text,
- a tokenizer (quotes, `;` separators, `#`/`//` comments),
- a *deferred* queue drained once per frame, with the `wait [N]` built-in
  gating execution N frames (this is the engine's scripting/test harness),
- `exec <file>` to run command scripts from disk,
- getopt-style `-flag value` parsing helper (cmd_getopt).

This is the substrate that `pt_test` runs on.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Dict, List, Optional

from pim.core.console import LogSev, con_logf
from pim.core.cvar import get_registry as _cvar_registry


class CmdStat(IntEnum):
    OK = 0
    ERR = 1


CmdFn = Callable[[List[str]], CmdStat]


@dataclass
class CmdDesc:
    name: str
    fn: CmdFn
    help: str = ""


class CmdSystem:
    def __init__(self) -> None:
        self._cmds: Dict[str, CmdDesc] = {}
        self._queue: List[List[str]] = []
        self._wait_frames: int = 0
        self.quit_requested: bool = False
        self.error_count: int = 0  # deferred-statement failures (batch exit code)
        self._register_builtins()

    # --- registry ---------------------------------------------------------

    def reg(self, name: str, fn: CmdFn, help: str = "") -> None:
        self._cmds[name.lower()] = CmdDesc(name.lower(), fn, help)

    def exists(self, name: str) -> bool:
        return name.lower() in self._cmds

    def complete(self, prefix: str) -> List[str]:
        return sorted(n for n in self._cmds if n.startswith(prefix.lower()))

    # --- tokenize ---------------------------------------------------------

    @staticmethod
    def tokenize(text: str) -> List[List[str]]:
        """Split a command line into statements (by ';' / newline) of tokens.
        Comment lines ('#' / '//') are dropped BEFORE the ';' split, so a
        semicolon inside a comment cannot leak a bogus statement."""
        statements: List[List[str]] = []
        lines = []
        for raw in text.splitlines():
            s = raw.strip()
            if not s or s.startswith("#") or s.startswith("//"):
                continue
            lines.extend(s.split(";"))
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            lex = shlex.shlex(line, posix=True)
            lex.whitespace_split = True
            lex.commenters = ""
            try:
                tokens = list(lex)
            except ValueError:
                tokens = line.split()
            if tokens:
                statements.append(tokens)
        return statements

    # --- execution --------------------------------------------------------

    def enqueue(self, text: str) -> None:
        self._queue.extend(self.tokenize(text))

    def immediate(self, text: str) -> CmdStat:
        status = CmdStat.OK
        for argv in self.tokenize(text):
            status = self._exec_statement(argv)
        return status

    def _exec_statement(self, argv: List[str]) -> CmdStat:
        name = argv[0].lower()
        desc = self._cmds.get(name)
        if desc is not None:
            try:
                return desc.fn(argv)
            except Exception as ex:  # command errors must not kill the loop
                con_logf(LogSev.Error, "cmd", "%s raised: %r", name, ex)
                return CmdStat.ERR
        # fall back to cvar get/set, like the reference console
        cv = _cvar_registry().find(argv[0])
        if cv is not None:
            if len(argv) > 1:
                cv.set_str(" ".join(argv[1:]))
            else:
                con_logf(LogSev.Info, "cvar", "%s = %s", cv.name, cv.as_str())
            return CmdStat.OK
        con_logf(LogSev.Error, "cmd", "unknown command '%s'", argv[0])
        return CmdStat.ERR

    def update(self) -> None:
        """Drain the deferred queue; called once per frame."""
        if self._wait_frames > 0:
            self._wait_frames -= 1
            return
        while self._queue:
            argv = self._queue.pop(0)
            if argv[0].lower() == "wait":
                self._wait_frames = int(argv[1]) if len(argv) > 1 else 1
                if self._wait_frames > 0:
                    self._wait_frames -= 1  # this frame counts as one
                    return
                continue
            if self._exec_statement(argv) != CmdStat.OK:
                self.error_count += 1

    def pending(self) -> bool:
        return bool(self._queue) or self._wait_frames > 0

    # --- builtins ---------------------------------------------------------

    def _register_builtins(self) -> None:
        def cmd_help(argv: List[str]) -> CmdStat:
            for name in sorted(self._cmds):
                con_logf(LogSev.Info, "cmd", "%-20s %s", name, self._cmds[name].help)
            return CmdStat.OK

        def cmd_exec(argv: List[str]) -> CmdStat:
            if len(argv) < 2:
                con_logf(LogSev.Error, "cmd", "usage: exec <file>")
                return CmdStat.ERR
            try:
                with open(argv[1]) as f:
                    self.enqueue(f.read())
                return CmdStat.OK
            except OSError as ex:
                con_logf(LogSev.Error, "cmd", "exec failed: %s", ex)
                return CmdStat.ERR

        def cmd_quit(argv: List[str]) -> CmdStat:
            self.quit_requested = True
            return CmdStat.OK

        def cmd_cvars(argv: List[str]) -> CmdStat:
            for name, cv in sorted(_cvar_registry().all().items()):
                con_logf(LogSev.Info, "cvar", "%-20s = %-16s %s", name, cv.as_str(), cv.desc)
            return CmdStat.OK

        self.reg("help", cmd_help, "list commands")
        self.reg("exec", cmd_exec, "execute a command script file")
        self.reg("quit", cmd_quit, "request engine shutdown")
        self.reg("cvars", cmd_cvars, "list console variables")


def cmd_getopt(argv: List[str], name: str, flag: bool = False):
    """Find `-name value` (or `--name value`) in argv; ref cmd_getopt.
    With flag=True, returns a bool: whether bare `-name` is present."""
    for i, tok in enumerate(argv):
        if tok in (f"-{name}", f"--{name}"):
            if flag:
                return True
            if i + 1 < len(argv):
                return argv[i + 1]
            return ""
    return False if flag else None


_system = CmdSystem()


def get_cmd_system() -> CmdSystem:
    return _system


def cmd_reg(name: str, fn: CmdFn, help: str = "") -> None:
    _system.reg(name, fn, help)


def cmd_enqueue(text: str) -> None:
    _system.enqueue(text)


def cmd_immediate(text: str) -> CmdStat:
    return _system.immediate(text)
