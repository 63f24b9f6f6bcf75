"""Multi-host distributed runtime (SURVEY.md §2.9).

The reference is single-process shared-memory (its socket layer is a dead
stub, src/os/socket.c; the task pool src/threading/task.c:179-230 is the
only fork-join machinery).  The scale-out axis here is
`jax.distributed` multi-controller SPMD: every host runs the same program,
`jax.devices()` federates all cards, and one global `Mesh` over the 'dp'
axis shards the ray/pixel/texel space while the scene stays replicated.
Collectives (`psum` of light histograms and gradients) are inserted by
XLA from the shardings and run over NCCL; the cards of one host are
joined all to all, so the mesh follows the pixel split alone.

Environment contract (mirrors the cvar-style config surface):
  PIM_COORDINATOR   "host:port" of process 0  (default 127.0.0.1:7621)
  PIM_NUM_PROCS     world size                (default 1 -> no-op)
  PIM_PROC_ID       this process's rank

On CPU backends (tests / the virtual scaling harness) the gloo collectives
implementation is selected automatically before backend init.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class DistInfo(NamedTuple):
    process_id: int
    num_processes: int
    coordinator: str

    @property
    def is_main(self) -> bool:
        return self.process_id == 0


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistInfo:
    """Initialize the multi-host runtime.  Must run before any backend use.

    Single-process (num_processes <= 1) is a no-op, so every entry point
    can call this unconditionally — the single-chip path, the pytest CPU
    path, and `__graft_entry__.dryrun_multichip` all flow through here.
    """
    coordinator = coordinator or os.environ.get(
        "PIM_COORDINATOR", "127.0.0.1:7621"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("PIM_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PIM_PROC_ID", "0"))

    # CPU backends need a cross-process collectives impl picked before the
    # backend exists (the CPU harness of tools/scaling_bench.py)
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        import jax

        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    if num_processes <= 1:
        return DistInfo(0, 1, coordinator)

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        # compile-time skew between ranks on a shared/pinned-core host can
        # exceed the 300s default shutdown barrier (seen in the lmbake
        # scaling world: one rank still compiling while the other finished
        # the whole run); a slow rank must not kill the world
        initialization_timeout=int(os.environ.get("PIM_DIST_INIT_S", "600")),
        heartbeat_timeout_seconds=int(os.environ.get("PIM_DIST_HB_S", "300")),
        shutdown_timeout_seconds=int(
            os.environ.get("PIM_DIST_SHUTDOWN_S", "900")),
    )
    return DistInfo(process_id, num_processes, coordinator)


def global_mesh(axis: str = "dp"):
    """One mesh over every device of every process, process-major — 'dp'
    shards land contiguous per host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def replicate(tree, mesh):
    """Device_put a host-local pytree as fully-replicated global arrays
    (the scene/BVH/texture tables: TP=1 per SURVEY §2.9)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, spec), tree)


def process_local_slice(n: int) -> slice:
    """This process's contiguous row range of a ['dp']-sharded leading
    axis of global length n."""
    import jax

    pc = jax.process_count()
    pid = jax.process_index()
    assert n % pc == 0, f"global size {n} must divide process count {pc}"
    per = n // pc
    return slice(pid * per, (pid + 1) * per)


def allgather_rows(local_rows: np.ndarray):
    """Host-side gather of a ['dp']-sharded array's rows from every process
    (the screenshot/checkpoint readback path)."""
    import jax

    if jax.process_count() == 1:
        return local_rows
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(local_rows)).reshape(
        (-1,) + local_rows.shape[1:]
    )
