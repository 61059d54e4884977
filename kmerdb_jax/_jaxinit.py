"""Lazy, idempotent JAX import + configuration.

Importing jax costs several seconds of interpreter time; CLI modes
that never touch a device (distance, minhash, host-path queries) must
not pay it.  Every module that needs jax obtains it through
jax_modules(), which applies the project configuration exactly once:

* 64-bit mode — packed k-mers and MurmurHash-style mixing are uint64
  (reference src/types.h kmer_t); must be set before any jnp use.
* persistent compile cache — JAX_COMPILATION_CACHE_DIR when it is set
  (JAX reads it itself; nothing else is configured then), otherwise a
  fixed `.jax_cache/` in the checkout.  A fixed path is part of the
  cache key, so later processes find what earlier ones compiled.
"""

import os
import pathlib

_configured = False

#: default compile cache: a fixed, gitignored directory in the checkout
CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def jax_modules():
    """Returns (jax, jax.numpy), configured on first call."""
    global _configured
    import jax

    if not _configured:
        jax.config.update("jax_enable_x64", True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
        _configured = True

    import jax.numpy as jnp
    return jax, jnp


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU — the one gate every
    device tier's automatic routing goes through.  Initializes the
    backend, so callers decide what they can before asking."""
    jax, _ = jax_modules()
    return jax.default_backend() == "gpu"
