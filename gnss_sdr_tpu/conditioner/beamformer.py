"""Antenna-array beamformer (weighted channel combiner).

Counterpart of the reference's ``Beamformer_Filter``
(reference: src/algorithms/input_filter/adapters/beamformer_filter.cc and
gnuradio_blocks/beamformer.cc:54-60 — per-sample sum of the 8 antenna
channels times a complex weight vector). Here the combination is one
batched planar complex contraction over the antenna axis, plus a
steering-vector helper for a uniform linear array (the reference leaves
weights to configuration; phased steering is the standard way to set
them)."""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def beamform(x_re, x_im, w_re, w_im):
    """[M, N] planar antenna channels x [M] complex weights -> [N]."""
    comb = functools.partial(jnp.einsum, "mn,m->n",
                             precision=jax.lax.Precision.HIGHEST)
    y_re = comb(x_re, w_re) - comb(x_im, w_im)
    y_im = comb(x_re, w_im) + comb(x_im, w_re)
    return y_re, y_im


def steering_weights(n_antennas: int, spacing_wavelengths: float,
                     steer_deg: float) -> np.ndarray:
    """Phase-steering weights for a uniform linear array: w_m =
    exp(-j 2 pi d m sin(theta)) / M (conventional beamformer)."""
    m = np.arange(n_antennas)
    phase = -2.0 * math.pi * spacing_wavelengths * m * math.sin(
        math.radians(steer_deg))
    return np.exp(1j * phase) / n_antennas


def array_response(n_antennas: int, spacing_wavelengths: float,
                   doa_deg: float) -> np.ndarray:
    """Plane-wave array manifold vector for a ULA."""
    m = np.arange(n_antennas)
    phase = 2.0 * math.pi * spacing_wavelengths * m * math.sin(
        math.radians(doa_deg))
    return np.exp(1j * phase)


class BeamformerFilter:
    """Stateless M-channel -> 1-channel combiner (adapter role)."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.complex64)
        self._w_re = jnp.asarray(w.real)
        self._w_im = jnp.asarray(w.imag)
        self.n_antennas = w.shape[0]

    @classmethod
    def steered(cls, n_antennas: int = 8, spacing_wavelengths: float = 0.5,
                steer_deg: float = 0.0) -> "BeamformerFilter":
        return cls(steering_weights(n_antennas, spacing_wavelengths,
                                    steer_deg))

    def apply(self, x: np.ndarray) -> np.ndarray:
        """[M, N] complex -> [N] complex (NumPy convenience path)."""
        x = np.asarray(x)
        if x.shape[0] != self.n_antennas:
            raise ValueError(
                f"expected {self.n_antennas} antenna channels, "
                f"got {x.shape[0]}")
        re, im = beamform(
            jnp.asarray(np.ascontiguousarray(x.real, np.float32)),
            jnp.asarray(np.ascontiguousarray(x.imag, np.float32)),
            self._w_re, self._w_im)
        return np.asarray(re) + 1j * np.asarray(im)
