"""Engine shell: init -> frame loop -> shutdown (headless).

Counterpart of src/main.c:27-111's frame loop, minus window/input/audio/UI
(non-goals per SURVEY.md §7).  Frame order mirrors the reference: time ->
command queue -> render -> profiler; `quit` (or the queue draining in batch
mode) ends the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from pim.core import cvars  # noqa: F401 — registers the engine cvars
from pim.core.cmd import get_cmd_system
from pim.core.console import LogSev, con_logf, get_console
from pim.core.profiler import get_profiler, profile
from pim.core.timesys import get_timesys
from pim.render.render_system import RenderSystem


@dataclass
class Engine:
    width: Optional[int] = None
    height: Optional[int] = None
    max_frames: Optional[int] = None

    render: RenderSystem = None
    frame: int = 0

    def init(self) -> None:
        from pim.core.compile_cache import enable_compile_cache
        from pim.core.cvars import (
            cv_con_logpath, cv_r_height, cv_r_scale, cv_r_width,
        )

        enable_compile_cache()

        if cv_con_logpath.get():
            get_console().set_log_path(cv_con_logpath.get())
        # explicit --width/--height pin the base-resolution cvars (the
        # reference's window size); r_scale then applies on top, exactly
        # like the reference render-target sizing (cvars.c:136-168)
        if self.width is not None:
            cv_r_width.set(self.width)
        if self.height is not None:
            cv_r_height.set(self.height)
        w = max(1, int(round(cv_r_width.get() * cv_r_scale.get())))
        h = max(1, int(round(cv_r_height.get() * cv_r_scale.get())))
        if self.width is None and self.height is None and w * h > (1 << 20):
            # cvar defaults resolve to 1920x1080 (reference parity,
            # cvars.c:150-168) — ~32x a 256² batch frame.  Headless runs
            # that didn't ask for it should not mistake this for a hang
            # (ADVICE r3).
            con_logf(
                LogSev.Warning, "app",
                "no --width/--height given; cvars resolve to %dx%d "
                "(r_width*r_scale) — pass --width/--height or set r_scale "
                "for faster batch runs", w, h,
            )
        self.render = RenderSystem(width=w, height=h)
        self.render.init()
        con_logf(LogSev.Info, "app", "pim engine initialized (%dx%d)", w, h)

    def update(self) -> None:
        ts = get_timesys()
        ts.update()
        cmds = get_cmd_system()
        with profile("cmd"):
            cmds.update()
        with profile("render"):
            self.render.update()
        self.frame += 1

    def run(self, script: Optional[str] = None) -> int:
        """Batch mode: enqueue a script, loop until quit or queue drained.
        Returns a process exit code: nonzero when any deferred command
        failed (the pt_test/gate regression contract)."""
        cmds = get_cmd_system()
        if script:
            cmds.enqueue(script)
        while not cmds.quit_requested:
            self.update()
            if self.max_frames is not None and self.frame >= self.max_frames:
                break
            if not cmds.pending() and script is not None:
                break
        return 1 if cmds.error_count else 0

    def shutdown(self) -> None:
        prof = get_profiler()
        if prof.stats:
            con_logf(LogSev.Verbose, "prof", "\n%s", prof.report())


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="pim headless engine")
    parser.add_argument("--exec", dest="script", default=None,
                        help="command script to run (e.g. 'pt_test -frames 64')")
    parser.add_argument("--width", type=int, default=None,
                        help="base render width (default: cvar r_width)")
    parser.add_argument("--height", type=int, default=None,
                        help="base render height (default: cvar r_height)")
    parser.add_argument("--frames", type=int, default=None)
    args = parser.parse_args()

    engine = Engine(width=args.width, height=args.height, max_frames=args.frames)
    engine.init()
    rc = engine.run(args.script)
    engine.shutdown()
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
