"""PCPS magnitude grid (jnp.fft, complex64) vs the float64 NumPy reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnss_sdr_tpu.acquisition.pcps import (_pcps_magnitude_grid,
                                           magnitude_grid_reference)

FS = 4.0e6
#: float32 transforms of up to ~1e4 points vs float64
TOL = 1e-4


def _inputs(n, p, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    codes = np.sign(rng.standard_normal((p, n)))
    code_fft = np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64)
    dopplers = np.linspace(-5000.0, 5000.0, d).astype(np.float32)
    return x, code_fft, dopplers


def _grid(x, code_fft, dopplers, offset, eff):
    return np.asarray(_pcps_magnitude_grid(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        jnp.asarray(code_fft.real), jnp.asarray(code_fft.imag),
        jnp.asarray(dopplers), jnp.float32(FS), offset=offset, eff=eff))


def _assert_close(got, ref):
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= TOL * np.max(ref)


@pytest.mark.parametrize("n", [64, 100, 2046, 2500, 4000, 8000, 5115])
def test_grid_matches_float64_reference(n):
    x, code_fft, dopplers = _inputs(n, 2, 3, seed=n)
    got = _grid(x, code_fft, dopplers, 0, n)
    _assert_close(got, magnitude_grid_reference(x, code_fft, dopplers, FS,
                                                0, n))


def test_batched_prn_by_doppler_grid():
    """P x D batching: every (PRN, Doppler) row equals its own reference
    and the peak lands on the planted code phase and Doppler bin."""
    n, p, d = 1000, 5, 7
    x, code_fft, dopplers = _inputs(n, p, d, seed=3)
    codes = np.fft.ifft(np.conj(code_fft), axis=-1)
    t = np.arange(n)
    x = x + 8.0 * np.roll(codes[2], 123) * np.exp(
        2j * np.pi * dopplers[4] * t / FS)
    got = _grid(x.astype(np.complex64), code_fft, dopplers, 0, n)
    ref = magnitude_grid_reference(x, code_fft, dopplers, FS, 0, n)
    _assert_close(got, ref)
    assert got.shape == (p, d, n)
    assert np.unravel_index(np.argmax(got[2]), (d, n)) == (4, 123)


def test_bit_transition_slice():
    """The doubled-FFT layout reads ``eff`` cells from ``offset``."""
    eff = 500
    x, code_fft, dopplers = _inputs(2 * eff, 3, 4, seed=11)
    got = _grid(x, code_fft, dopplers, eff, eff)
    full = magnitude_grid_reference(x, code_fft, dopplers, FS, 0, 2 * eff)
    assert got.shape == (3, 4, eff)
    _assert_close(got, full[..., eff:])


def test_inverse_round_trip():
    """An impulse replica at zero Doppler makes the grid FFT -> IFFT of
    the input itself: |x|^2 sample by sample."""
    n = 4000
    x, _, _ = _inputs(n, 1, 1, seed=5)
    ones = np.ones((1, n), np.complex64)  # conj(FFT(delta))
    got = _grid(x, ones, np.zeros(1, np.float32), 0, n)[0, 0]
    np.testing.assert_allclose(got, np.abs(x) ** 2,
                               atol=TOL * np.max(np.abs(x) ** 2))


def test_large_prime_size_accepted():
    """Any transform length is accepted, large primes included."""
    n = 8191
    x, code_fft, dopplers = _inputs(n, 1, 2, seed=8191)
    got = _grid(x, code_fft, dopplers, 0, n)
    _assert_close(got, magnitude_grid_reference(x, code_fft, dopplers, FS,
                                                0, n))
