"""Test configuration: run on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh; the GPU path is
checked on the card by chip_smoke.py, not by this suite.  The backend is
pinned with jax.config (as well as JAX_PLATFORMS=cpu), which must run
before backends initialise.

Tiers: the default run uses smaller configurations for the most expensive
tests so the suite stays fast enough to be run habitually; SUITE_FULL=1
restores every test's full-scale configuration (release rounds / after
integrator changes).  GOLDEN_ALL=1 separately widens the golden-image
sweep (see test_parity_images.py).
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent XLA compilation cache: the suite is compile-dominated on CPU
# and the cache is content-hashed (HLO + backend config), so repeat runs
# skip every unchanged program.  First run populates ~hundreds of entries.
#
# The cache directory is keyed by the host's CPU feature set: the content
# hash does NOT include machine features, so an XLA:CPU AOT executable
# compiled on a different box loads with "machine type ... doesn't match"
# warnings and can SIGILL/segfault mid-suite (observed round 4: a
# 95%-through segfault loading feature-mismatched entries; the cache dir
# outlives CI host reassignments).  A new host simply repopulates.


def _cpu_feature_tag() -> str:
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return platform.machine() or "unknown"


# The base directory is the entry points' (JAX_COMPILATION_CACHE_DIR when
# set, else the checkout's .jax_cache), with the CPU-feature tag below it.
try:
    from geodesic_raytracing.utils import compile_cache

    _cache = compile_cache.enable(os.path.join("cpu_tests",
                                               _cpu_feature_tag()))
    os.makedirs(_cache, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
except Exception:  # noqa: BLE001 — cache is an optimisation only
    pass

SUITE_FULL = bool(os.environ.get("SUITE_FULL"))


def tier(fast, full):
    """Pick the fast-tier or full-tier value for a test configuration."""
    return full if SUITE_FULL else fast
