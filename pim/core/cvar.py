"""Typed console variables with dirty-version tracking and JSON persistence.

Re-implements the reference's cvar tier (src/common/cvar.h:19-47, cvars.c):
typed values with min/max clamping, a monotonically increasing `version`
counter that consumers poll to invalidate bakes (ConVar_CheckDirty), a save
flag, and JSON save/load.  The registry of engine cvars lives in
`pim.core.cvars` (mirroring src/common/cvars.c's single registry file).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, Optional, Tuple


class CVarType(IntEnum):
    Text = 0
    Float = 1
    Int = 2
    Bool = 3
    Vector = 4  # 4-float direction (normalized on set)
    Point = 5   # 4-float position
    Color = 6   # 4-float color


class CVarFlag(IntEnum):
    NONE = 0
    SAVE = 1 << 0


@dataclass
class CVar:
    name: str
    type: CVarType
    value: Any
    desc: str = ""
    min: float = float("-inf")
    max: float = float("inf")
    flags: int = CVarFlag.NONE
    version: int = field(default=1)

    def get(self) -> Any:
        return self.value

    def set(self, value: Any) -> None:
        value = self._coerce(value)
        if value != self.value:
            self.value = value
            self.version += 1

    def _coerce(self, value: Any) -> Any:
        t = self.type
        if t == CVarType.Text:
            return str(value)
        if t == CVarType.Float:
            return float(min(max(float(value), self.min), self.max))
        if t == CVarType.Int:
            return int(min(max(int(value), self.min), self.max))
        if t == CVarType.Bool:
            if isinstance(value, str):
                return value.strip().lower() not in ("0", "false", "off", "no", "")
            return bool(value)
        if t in (CVarType.Vector, CVarType.Point, CVarType.Color):
            vals = [float(v) for v in value]
            while len(vals) < 4:
                vals.append(0.0)
            if t == CVarType.Color:
                vals = [min(max(v, self.min), self.max) for v in vals]
            return tuple(vals[:4])
        raise ValueError(f"unknown cvar type {t}")

    def set_str(self, text: str) -> None:
        if self.type in (CVarType.Vector, CVarType.Point, CVarType.Color):
            parts = text.replace(",", " ").split()
            self.set(parts)
        else:
            self.set(text)

    def as_str(self) -> str:
        if isinstance(self.value, tuple):
            return " ".join(f"{v:g}" for v in self.value)
        if isinstance(self.value, bool):
            return "1" if self.value else "0"
        return str(self.value)

    def check_dirty(self, last_version: int) -> Tuple[bool, int]:
        """Returns (dirty, current_version) — mirror of ConVar_CheckDirty."""
        return (self.version != last_version, self.version)


class CVarRegistry:
    def __init__(self) -> None:
        self._vars: Dict[str, CVar] = {}

    def register(self, cvar: CVar) -> CVar:
        if cvar.name in self._vars:
            return self._vars[cvar.name]
        self._vars[cvar.name] = cvar
        return cvar

    def find(self, name: str) -> Optional[CVar]:
        return self._vars.get(name)

    def all(self) -> Dict[str, CVar]:
        return dict(self._vars)

    def complete(self, prefix: str):
        return sorted(n for n in self._vars if n.startswith(prefix))

    def save(self, path: str) -> None:
        data = {
            name: {"type": int(cv.type), "value": cv.value}
            for name, cv in self._vars.items()
            if cv.flags & CVarFlag.SAVE
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def load(self, path: str) -> bool:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        for name, rec in data.items():
            cv = self.find(name)
            if cv is not None:
                val = rec.get("value")
                if isinstance(val, list):
                    val = tuple(val)
                try:
                    cv.set(val)
                except (TypeError, ValueError):
                    pass
        return True


_registry = CVarRegistry()


def get_registry() -> CVarRegistry:
    return _registry


def cvar(
    name: str,
    type: CVarType,
    value: Any,
    desc: str = "",
    min: float = float("-inf"),
    max: float = float("inf"),
    flags: int = CVarFlag.NONE,
) -> CVar:
    cv = CVar(name=name, type=type, value=None, desc=desc, min=min, max=max, flags=flags)
    cv.value = cv._coerce(value)
    return _registry.register(cv)
