"""Facts about the machine for scripts that run on the GPU: the card's
name and power limit, and where the persistent compile cache lives."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path


def card_line() -> str:
    """``name, power.limit`` of each card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  Runs in a child process that does not import JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def use_compile_cache(jax, checkout: Path) -> None:
    """Persistent compile cache: JAX reads ``JAX_COMPILATION_CACHE_DIR``
    itself; without it, ``<checkout>/.jax_cache`` (listed in .gitignore),
    a fixed path so repeated runs hit."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir", str(Path(checkout) / ".jax_cache")
        )
