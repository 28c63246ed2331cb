"""Test configuration: run everything on a virtual 8-device CPU mesh.

Virtual host devices are requested through XLA_FLAGS and the platform is
pinned to the CPU through jax.config before any backend is created, so the
multi-device sharding tests run on 8 virtual CPU devices without any
accelerator (SURVEY.md §4).  Tests that need a GPU carry the ``gpu`` marker
and skip here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the CPU unless the caller names a platform (the gpu-marked tests run with
# JAX_PLATFORMS=cuda,cpu on a machine with a card)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is dominated by CPU jit compiles.
# JAX reads JAX_COMPILATION_CACHE_DIR itself; without it, a fixed directory
# inside the checkout (listed in .gitignore).  Correctness runs are
# unaffected (keys cover HLO + flags + platform).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jax_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
