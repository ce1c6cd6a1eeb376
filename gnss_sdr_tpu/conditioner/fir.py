"""Input filters: FIR band-pass and frequency-translating decimating FIR.

Counterparts of the reference's input_filter adapters
(/root/reference/src/algorithms/input_filter/adapters/fir_filter.cc and
freq_xlating_fir_filter.cc): taps designed with Parks-McClellan from
configured bands (the reference uses gr::filter::pm_remez; we use
scipy.signal.remez on the host), filtering applied on device in planar
complex via convolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as sp_signal

from gnss_sdr_tpu.ops.cplx import Cf


def design_lowpass_taps(
    fs: float, cutoff_hz: float, transition_hz: float, ntaps: int = 65,
) -> np.ndarray:
    """Parks-McClellan lowpass (fir_filter.cc band-spec semantics)."""
    edges = [0, cutoff_hz, cutoff_hz + transition_hz, fs / 2]
    taps = sp_signal.remez(ntaps, edges, [1, 0], fs=fs)
    return taps.astype(np.float32)


def fir_filter(x: Cf, taps: np.ndarray, decimation: int = 1) -> Cf:
    """Causal FIR filter (real taps) on planar complex samples.

    Output n = sum_k taps[k] * x[n - k]; optionally keep every
    ``decimation``-th output (gr FIR decimator semantics).
    """
    t = jnp.asarray(taps, dtype=jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    xr = jnp.convolve(x[0], t, mode="full", precision=hi)[: x[0].shape[0]]
    xi = jnp.convolve(x[1], t, mode="full", precision=hi)[: x[1].shape[0]]
    if decimation > 1:
        xr = xr[::decimation]
        xi = xi[::decimation]
    return (xr, xi)


def freq_xlating_fir_filter(
    x: Cf, taps: np.ndarray, center_freq_hz: float, fs: float,
    decimation: int = 1,
) -> Cf:
    """Frequency-translate (IF -> baseband) then decimating lowpass.

    Mirrors gr::filter::freq_xlating_fir_filter as used by the reference's
    Freq_Xlating_Fir_Filter adapter: x * e^{-j 2 pi f0 n / fs} -> FIR ->
    keep every D-th sample.
    """
    n = jnp.arange(x[0].shape[0], dtype=jnp.float32)
    ph = (-2.0 * jnp.pi * center_freq_hz / fs) * n
    c, s = jnp.cos(ph), jnp.sin(ph)
    shifted = (x[0] * c - x[1] * s, x[0] * s + x[1] * c)
    return fir_filter(shifted, taps, decimation)
