"""Test harness configuration.

Runs all tests on the CPU backend with 8 virtual devices so sharding tests
exercise multi-device code paths without accelerator hardware. Platform
and device count are set through jax.config before any backend is
initialized, so they hold whatever the calling environment sets. The GPU
itself is exercised by ``python chip_smoke.py``.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# several test workers share the checkout: none writes the persistent
# compilation cache that the command-line entry point places there
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_DIR = "/root/reference"


def reference_sample_file(name: str) -> str | None:
    """Path to a recorded IF fixture from the reference repo, if present."""
    path = os.path.join(REFERENCE_DIR, "src/tests/signal_samples", name)
    return path if os.path.exists(path) else None
