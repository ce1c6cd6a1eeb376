"""Interference mitigation: pulse blanking and narrowband excision.

Counterparts of the reference's anti-jamming input filters
(/root/reference/src/algorithms/input_filter/gnuradio_blocks/
pulse_blanking_cc.cc and notch_cc.cc / notch_lite_cc.cc):

- :func:`pulse_blanking` zeroes samples whose instantaneous power exceeds
  a multiple of the block's noise estimate (the reference's
  pfa-threshold-over-segments scheme reduced to its array form).
- :func:`notch_filter_block` removes narrowband (CW) interference. The
  reference runs an adaptive time-domain IIR notch steered by a
  frequency estimator; here the array-program equivalent is
  frequency-domain excision: FFT the block, clamp bins whose magnitude
  exceeds ``k x median``, IFFT. Same capability, compiler-friendly shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gnss_sdr_tpu.ops.cplx import Cf


def pulse_blanking(x: Cf, threshold_sigma: float = 4.0) -> Cf:
    """Zero samples with |x|^2 above (threshold_sigma^2 x mean power)."""
    power = x[0] * x[0] + x[1] * x[1]
    mean_p = jnp.mean(power)
    keep = power <= (threshold_sigma * threshold_sigma) * mean_p
    return (jnp.where(keep, x[0], 0.0), jnp.where(keep, x[1], 0.0))


def notch_filter_block(x: Cf, excision_factor: float = 8.0) -> Cf:
    """Frequency-domain narrowband excision over one block.

    Bins with magnitude > excision_factor x median magnitude are zeroed
    (CW interference concentrates in few bins; GNSS signal power is ~20 dB
    below the noise floor and untouched).
    """
    spec = jnp.fft.fft(jax.lax.complex(x[0], x[1]), axis=-1)
    mag = jnp.abs(spec)
    med = jnp.median(mag, axis=-1, keepdims=True)
    out = jnp.fft.ifft(jnp.where(mag <= excision_factor * med, spec, 0.0),
                       axis=-1)
    return (out.real, out.imag)
