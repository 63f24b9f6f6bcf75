"""Multi-host scaling harness (BASELINE scaling row).

Launches tools/scaling_worker.py as N separate OS processes joined via
`jax.distributed` (gloo collectives over loopback — the same
process-federation code path a multi-host run uses).  It is a CPU harness:
every worker gets JAX_PLATFORMS=cpu explicitly, so N workers never open
the GPU N times (one JAX process per card).  Weak scaling: each process
keeps a fixed per-process pixel count, so ideal scaling holds wall time
constant while global throughput grows linearly.

Efficiency(N) = (paths/s at N procs) / (N * paths/s at 1 proc).

Each rank is PINNED to its own core (taskset): the ≥80%-efficiency
target measures communication/sync overhead, which requires per-process
compute resources to stay constant as the world grows.  Worlds larger
than the core count are CPU-starved, not communication-bound — the
harness refuses them unless PIM_SCALE_OVERSUBSCRIBE=1 (the numbers then
measure host contention, not the framework).

Usage:  python tools/scaling_bench.py [procs ...]   (default: 1 2)
Writes SCALING.md at the repo root with the measured table.
"""

import json
import os
import subprocess
import sys
import time

BASE_PORT = 7631
NCORES = os.cpu_count() or 1


def run_world(nprocs: int, steps: int = None, devs_per_proc: int = 1) -> dict:
    if steps is None:
        steps = int(os.environ.get("PIM_SCALE_STEPS", "32"))
    env_common = dict(
        os.environ,
        JAX_PLATFORMS="cpu",  # a CPU harness: the workers stay off the GPU
        PIM_COORDINATOR=f"127.0.0.1:{BASE_PORT + nprocs + 37 * devs_per_proc}",
        PIM_NUM_PROCS=str(nprocs),
        PIM_SCALE_STEPS=str(steps),
        PIM_DEVS_PER_PROC=str(devs_per_proc),
    )
    pinned = nprocs <= NCORES
    if not pinned and not os.environ.get("PIM_SCALE_OVERSUBSCRIBE"):
        raise SystemExit(
            f"world {nprocs} > {NCORES} cores: oversubscribed numbers "
            "measure host contention, not scaling; set "
            "PIM_SCALE_OVERSUBSCRIBE=1 to force")
    procs = []
    for rank in range(nprocs):
        env = dict(env_common, PIM_PROC_ID=str(rank))
        argv = [sys.executable, "tools/scaling_worker.py"]
        if pinned:
            # highest core first: core 0 also hosts the OS/relay noise, so
            # rank 0 (the reporting rank) gets the quietest core
            argv = ["taskset", "-c", str(NCORES - 1 - (rank % NCORES))] + argv
        procs.append(subprocess.Popen(
            argv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        ))
    out0, err0 = procs[0].communicate(timeout=1800)
    for p in procs[1:]:
        p.communicate(timeout=1800)
    for line in out0.splitlines():
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"rank 0 of world {nprocs} printed no result; stderr:\n{err0[-2000:]}")


def _parse_world(a: str):
    """'2' -> (2 procs, 1 dev/proc); '2x4' -> (2 procs, 4 devs/proc)."""
    if "x" in a:
        p, d = a.split("x")
        return int(p), int(d)
    return int(a), 1


def write_lmbake_section(rows):
    """Append/replace the '## Lightmap bake' STRONG-scaling section of
    SCALING.md (texels of ONE map sharded across ranks; ideal = wall
    halves per doubling)."""
    base = rows[0]["mpaths_per_s"]
    lines = [
        "## Lightmap bake scaling",
        "",
        "Process-sharded progressive SG lightmap bake (PIM_SCALE_MODE=",
        "lmbake): one map's texel axis split into contiguous per-rank",
        "slices (the reference task pool's range claiming, lightmap.c:",
        "1125-1201), bit-identical to the unsharded bake",
        "(tests/test_lightmap.py).  STRONG scaling: total texels fixed.",
        "",
        "| procs | texels (padded) | steps | wall s | Mtexel-paths/s | speedup |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        sp = r["mpaths_per_s"] / base
        lines.append(
            f"| {r['nprocs']} | {r['pixels']} | {r['steps']} | "
            f"{r['wall_s']} | {r['mpaths_per_s']:.4f} | {sp:.2f}x |")
    block = "\n".join(lines) + "\n"
    marker = "## Lightmap bake scaling"
    txt = ""
    if os.path.exists("SCALING.md"):
        with open("SCALING.md") as f:
            txt = f.read()
    if marker in txt:
        txt = txt[: txt.index(marker)] + block
    else:
        txt += "\n" + block
    with open("SCALING.md", "w") as f:
        f.write(txt)
    print("appended lmbake section to SCALING.md")
    return rows


def main():
    worlds = [_parse_world(a) for a in sys.argv[1:]] or [
        (1, 1), (2, 1), (2, 2), (2, 4)]
    rows = []
    repeats = int(os.environ.get("PIM_SCALE_REPEATS", "3"))
    for n, d in worlds:
        best = None
        for _ in range(repeats):  # best-of-N: a shared host adds one-sided noise
            t0 = time.time()
            r = run_world(n, devs_per_proc=d)
            r["launch_s"] = round(time.time() - t0, 1)
            if best is None or r["mpaths_per_s"] > best["mpaths_per_s"]:
                best = r
        rows.append(best)
        print(json.dumps(best), flush=True)

    if os.environ.get("PIM_SCALE_MODE") == "lmbake":
        return write_lmbake_section(rows)

    base = rows[0]["mpaths_per_s"] / rows[0]["nprocs"]
    lines = [
        "# SCALING — multi-process weak-scaling harness",
        "",
        "`jax.distributed` worlds over loopback (gloo), each rank PINNED to",
        "its own core, Cornell 64x64/process, 3 bounces; the same",
        "process-federation + psum path a multi-host run uses.",
        "Worlds are `procs x devs/proc`: multi-device rows federate several",
        "virtual CPU devices per process (the shape of a host with several",
        "cards) through one global mesh — collectives then cross both",
        "the in-process device boundary and the gloo process boundary.",
        "Efficiency = mpaths/s / (nprocs * 1-proc mpaths/s): per-PROCESS",
        "weak scaling (per-process pixels fixed; a process's devices share",
        "its core, so devs/proc does not add compute, only mesh width).",
        "Process worlds beyond the core count are refused (they measure",
        "host contention, not the framework).",
        "",
        "| procs | devs/proc | mesh | global px | wall s | Mpaths/s | efficiency |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        eff = r["mpaths_per_s"] / (base * r["nprocs"])
        lines.append(
            f"| {r['nprocs']} | {r['devices'] // r['nprocs']} | "
            f"{r['devices']} | {r['pixels']} | {r['wall_s']} | "
            f"{r['mpaths_per_s']:.3f} | {eff * 100:.1f}% |")
        r["efficiency"] = round(eff, 4)
    lines.append("")
    with open("SCALING.md", "w") as f:
        f.write("\n".join(lines))
    print("wrote SCALING.md")
    return rows


if __name__ == "__main__":
    main()
