"""Planar complex values for the device compute path.

The tracking path carries complex data as explicit (re, im) float32
pairs, and the acquisition programs take and return planar arrays at
their boundaries (they form complex64 only inside, around the FFTs).
Host code keeps NumPy complex and converts at the boundary.

A "planar complex" value is a 2-tuple ``(re, im)`` of equal-shape float32
arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Cf = tuple  # (re, im)


def from_complex(x: np.ndarray) -> Cf:
    """Host complex array -> planar jnp pair."""
    x = np.asarray(x)
    return (jnp.asarray(np.ascontiguousarray(x.real, dtype=np.float32)),
            jnp.asarray(np.ascontiguousarray(x.imag, dtype=np.float32)))


def to_complex(a: Cf) -> np.ndarray:
    """Planar pair -> host complex64 array."""
    return (np.asarray(a[0]) + 1j * np.asarray(a[1])).astype(np.complex64)
