"""Reduce a jax.profiler trace to device metrics: the GPU device planes.

Reads the newest `.xplane.pb` under <dir>/plugins/profile/ with nothing
but JAX (`jax.profiler.ProfileData`), keeps the events of the
`/device:GPU:*` planes (the kernels on the card's streams; the
"XLA Modules" line repeats whole programs and is skipped), and reports
  * busy and idle share of the window (busy = union of kernel intervals);
  * kernel self time by name, top first.
A trace without a GPU device plane is an error, not an empty table.

Usage: python tools/analyze_trace.py <trace_dir>
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict

SKIP_LINES = ("XLA Modules", "Steps", "XLA TraceMe")


def device_events(trace_dir: str):
    """[(plane, line, kernel name, start_ns, duration_ns)] of the GPU
    device planes of the newest trace under `trace_dir`."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise SystemExit(f"no .xplane.pb trace under {trace_dir}")
    prof = ProfileData.from_file(paths[-1])
    planes = [p for p in prof.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(
            "no GPU device plane in the trace (planes: "
            + ", ".join(p.name for p in prof.planes) + ")")
    out = []
    for plane in planes:
        for line in plane.lines:
            if line.name in SKIP_LINES:
                continue
            for ev in line.events:
                out.append((plane.name, line.name, ev.name,
                            float(ev.start_ns), float(ev.duration_ns)))
    if not out:
        raise SystemExit("the GPU device planes hold no kernel events")
    return out


def busy_share(events) -> tuple[float, float]:
    """(busy ns, window ns) over the first device plane: busy is the union
    of kernel intervals, the window spans first start to last end."""
    first = events[0][0]
    iv = sorted((s, s + d) for p, _, _, s, d in events if p == first)
    busy = 0.0
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, iv[-1][1] - iv[0][0]


def kernel_table(events):
    """[(name, total ns, count)] sorted by total time."""
    tot = defaultdict(float)
    cnt = defaultdict(int)
    for _, _, name, _, dur in events:
        tot[name] += dur
        cnt[name] += 1
    return sorted(((k, v, cnt[k]) for k, v in tot.items()), key=lambda r: -r[1])


def main(trace_dir: str) -> None:
    events = device_events(trace_dir)
    busy, window = busy_share(events)
    print(f"device busy {busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms window "
          f"(idle share {1.0 - busy / max(window, 1.0):.4f})")
    rows = kernel_table(events)
    total = sum(r[1] for r in rows)
    print(f"{'kernel':70s} {'total_ms':>9s} {'count':>6s} {'avg_us':>8s} {'%':>6s}")
    for name, dur, c in rows[:45]:
        print(f"{name[:70]:70s} {dur / 1e6:9.3f} {c:6d} {dur / c / 1e3:8.1f} "
              f"{100 * dur / max(total, 1.0):6.2f}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/jaxtrace")
