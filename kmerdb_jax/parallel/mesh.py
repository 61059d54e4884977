"""Mesh construction helpers.

Axes:
* "shard" — the pattern/k-mer axis: the database's pattern chunks (and,
  during build, the k-mer key space) are partitioned across devices;
  partial count matrices merge with psum (NCCL between GPUs).
* (future, multi-host) an outer "host" axis for sample-batch data
  parallelism during ingest.
"""

import numpy as np

from .._jaxinit import jax_modules

jax, _ = jax_modules()  # configures x64 + compile cache
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def init_distributed() -> bool:
    """Multi-host entry point: initialize jax.distributed from the
    KMERDB_COORD / KMERDB_NUM_PROCS / KMERDB_PROC_ID environment
    (SURVEY §5 "Distributed communication backend": the reference has
    no multi-node story; here N hosts × M chips join one mesh and the
    DCN side is handled by jax.distributed + XLA collectives).

    Returns True when a multi-process runtime was initialized.  Call
    before any other JAX use; make_mesh() then sees the global device
    set."""
    import os
    coord = os.environ.get("KMERDB_COORD")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["KMERDB_NUM_PROCS"]),
        process_id=int(os.environ["KMERDB_PROC_ID"]))
    return True
