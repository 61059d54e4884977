"""CLI-facing mesh runtime: one process-global device mesh request.

The reference reaches multi-core execution from every console through
`-t <threads>` (src/params.cpp:103-108, consoles passing numThreads
into their worker pools).  The accelerator analogue is a device mesh:
`-mesh <n|auto>` (or KMERDB_MESH env) makes every console route its
compute through the SPMD kernels in parallel/sharded.py — same CLI
command, same byte output, N devices.

The request is stored lazily: nothing touches jax (backend init can
cost seconds, or hang on a stalled device service) until a console
actually asks for the mesh.  Multi-host runs set KMERDB_COORD /
KMERDB_NUM_PROCS / KMERDB_PROC_ID; active_mesh() then initializes
jax.distributed first, so the mesh spans every process's devices
(parallel/mesh.init_distributed).
"""

import os

_request: str | None = None
_mesh = None
_resolved = False


def configure(request: str | None) -> None:
    """Record the CLI -mesh value ("auto", "4", ...); None falls back
    to the KMERDB_MESH env.  Resets any previously resolved mesh (the
    CLI main calls this once per invocation; tests call it to switch
    geometries in-process)."""
    global _request, _mesh, _resolved
    _request = request
    _mesh = None
    _resolved = False


def active_mesh():
    """The requested Mesh, or None for single-device execution.

    Resolution: explicit configure() value > KMERDB_MESH env > none.
    "1" (or resolving to one device) means no mesh — the single-device
    tiers (packed incidence) are faster than a 1-device shard_map
    wrapper.  The first call initializes jax (and jax.distributed
    under KMERDB_COORD); later calls return the cached mesh."""
    global _mesh, _resolved
    if _resolved:
        return _mesh
    req = _request if _request is not None \
        else os.environ.get("KMERDB_MESH", "")
    if req in ("", "0", "1"):
        _resolved = True
        return None
    from . import mesh as mesh_mod
    mesh_mod.init_distributed()
    n = None if req == "auto" else int(req)
    m = mesh_mod.make_mesh(n)
    if m.devices.size <= 1:
        m = None
    _mesh, _resolved = m, True
    return _mesh
