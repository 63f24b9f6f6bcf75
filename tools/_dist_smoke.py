"""Smoke test: 2-process jax.distributed over CPU (gloo collectives)."""
import os
import sys

proc_id = int(sys.argv[1])
nprocs = int(sys.argv[2])
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:52345",
    num_processes=nprocs,
    process_id=proc_id,
)
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

devs = jax.devices()
print(f"proc {proc_id}: {len(devs)} global devices, "
      f"{len(jax.local_devices())} local", flush=True)
mesh = Mesh(np.asarray(devs), ("dp",))

x = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("dp")),
    np.full((4,), float(proc_id + 1), np.float32),
)


@jax.jit
def f(x):
    return jax.shard_map(
        lambda v: jax.lax.psum(jnp.sum(v), "dp"),
        mesh=mesh, in_specs=P("dp"), out_specs=P(),
    )(x)


out = f(x)
print(f"proc {proc_id}: psum = {out}", flush=True)
expect = sum(4.0 * (i + 1) for i in range(nprocs))
assert float(np.asarray(out)) == expect, (out, expect)
print(f"proc {proc_id}: OK", flush=True)
