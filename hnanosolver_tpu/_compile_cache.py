"""Where the persistent XLA compilation cache lives.

Imported by the package, so every entry point (CLI, bench, chip_smoke,
library use) shares one cache:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is
  set here.
- unset: ``<checkout>/.jax_cache`` (git-ignored). The path is fixed, never
  derived from a temp name, a process id or the time, because it is part
  of what a later process must find again.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def choose_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory this module sets, or None when the environment already
    names one (JAX then uses that and nothing here overrides it)."""
    if environ.get(ENV_VAR):
        return None
    return DEFAULT_DIR


def configure(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    path = choose_dir(environ)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


configure()
