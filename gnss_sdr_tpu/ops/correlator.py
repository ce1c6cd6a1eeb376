"""Carrier-wipeoff multicorrelator (planar complex).

Array-program equivalent of the reference's hot tracking loop — the fused
VOLK kernel pair ``volk_gnsssdr_32f_xn_resampler_32f_xn`` (tap-shifted code
resampling) + ``volk_gnsssdr_32fc_32f_rotator_dot_prod_32fc_xn`` (carrier
rotator + N dot products), as orchestrated by
Cpu_Multicorrelator_Real_Codes::Carrier_wipeoff_multicorrelator_resampler
(/root/reference/src/algorithms/tracking/libs/
cpu_multicorrelator_real_codes.cc:72-126).

Semantics reproduced exactly:

- code index per tap:  floor(code_step*n + shift - rem_code) mod L
  (volk_gnsssdr_32f_xn_resampler_32f_xn.h:62-80); all quantities in units
  of code-table entries (chips * code_samples_per_chip).
- carrier wipeoff: x[n] * e^{-j(rem_carr + step*n + 0.5*rate*n^2)}
  (phase_offset conjugate + phase_inc = e^{-j step},
  cpu_multicorrelator_real_codes.cc:113-126).

Complex samples travel as planar (re, im) float32 pairs, like the rest
of the tracking path, so the rotator is plain elementwise float32. One
call computes all taps of all channels as a batched masked reduction; an
invalid tail (n >= length) contributes zero, which makes per-channel
dynamic PRN-period lengths representable with one static shape.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def multicorrelate(
    x_re,                 # [..., L] float32 input samples (real part)
    x_im,                 # [..., L] float32 input samples (imag part)
    code_table,           # [..., code_len] float32 local code (+-1 chips)
    shifts,               # [T] float32 tap shifts in code-table units
    rem_code_phase,       # [...] float32, code-table units
    code_phase_step,      # [...] float32, code-table units per sample
    rem_carr_phase_rad,   # [...] float32
    carr_phase_step_rad,  # [...] float32
    length,               # [...] int32 valid samples this period
    carr_phase_rate_step_rad=None,   # [...] float32 (high-dyn) or None
    code_phase_rate_step=None,       # [...] float32 (high-dyn) or None
):
    """Return correlator outputs ([..., T] re, [..., T] im).

    ``...`` is any batch shape (channels). L is the static max period
    length; ``length`` masks the live prefix.
    """
    L = x_re.shape[-1]
    code_len = code_table.shape[-1]
    n = jnp.arange(L, dtype=jnp.float32)
    valid = n < length[..., None].astype(jnp.float32)

    # carrier wipeoff: multiply by e^{-j phase}
    phase = rem_carr_phase_rad[..., None] + carr_phase_step_rad[..., None] * n
    if carr_phase_rate_step_rad is not None:
        phase = phase + 0.5 * carr_phase_rate_step_rad[..., None] * n * n
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    rot_re = x_re * c + x_im * s
    rot_im = x_im * c - x_re * s
    rot_re = jnp.where(valid, rot_re, 0.0)
    rot_im = jnp.where(valid, rot_im, 0.0)

    if code_phase_rate_step is not None:
        # high-dynamics (quadratic code phase): fall back to the direct
        # per-sample gather (boundaries are no longer monotone-affine)
        base = code_phase_step[..., None] * n - rem_code_phase[..., None]
        base = base + 0.5 * code_phase_rate_step[..., None] * n * n
        idx = jnp.floor(base[..., None, :] + shifts[:, None]).astype(jnp.int32)
        idx = jnp.mod(idx, code_len)
        codes = jnp.take_along_axis(
            code_table[..., None, :], idx, axis=-1)
        corr_re = jnp.sum(codes * rot_re[..., None, :], axis=-1)
        corr_im = jnp.sum(codes * rot_im[..., None, :], axis=-1)
        return corr_re, corr_im

    # ---- segmented-sum evaluation (exact) -------------------------------
    # Sample n belongs to chip floor(step*n - rem + shift); since step > 0
    # those chips are a monotone partition: chip c spans samples
    # [ceil((c + rem - shift)/step), ...). One prefix-sum read per chip
    # boundary replaces the per-sample code gather (random loads),
    # and the chip sums contract against the code table. The two spill
    # bins (c = -1 and c = code_len) fold onto the mod-wrapped chips, so
    # results equal the gather formulation bit-for-bit up to f32
    # summation order.
    zeros1 = jnp.zeros(rot_re.shape[:-1] + (1,), dtype=rot_re.dtype)
    p_re = jnp.concatenate([zeros1, jnp.cumsum(rot_re, axis=-1)], axis=-1)
    p_im = jnp.concatenate([zeros1, jnp.cumsum(rot_im, axis=-1)], axis=-1)

    # spill range: tap shifts can span several chips (VEML at 12
    # code-samples/chip), so extend the bin domain by the worst shift
    n_extra = int(np.ceil(float(np.max(np.abs(np.asarray(shifts)))))) + 1
    cc = jnp.arange(-n_extra, code_len + n_extra + 1, dtype=jnp.float32)
    a = jnp.ceil((cc[None, :] + rem_code_phase[..., None, None]
                  - shifts[:, None])
                 / code_phase_step[..., None, None])       # [..., T, bins+1]
    a = jnp.clip(a, 0, L).astype(jnp.int32)
    pr = jnp.take_along_axis(p_re[..., None, :], a, axis=-1)
    pi_ = jnp.take_along_axis(p_im[..., None, :], a, axis=-1)
    seg_re = jnp.diff(pr, axis=-1)                         # chips -ne..cl+ne-1
    seg_im = jnp.diff(pi_, axis=-1)
    core_re = seg_re[..., n_extra:n_extra + code_len]
    core_im = seg_im[..., n_extra:n_extra + code_len]
    for j in range(n_extra):
        # chip -1-j wraps to code_len-1-j; chip code_len+j wraps to j
        core_re = core_re.at[..., code_len - 1 - j].add(
            seg_re[..., n_extra - 1 - j])
        core_im = core_im.at[..., code_len - 1 - j].add(
            seg_im[..., n_extra - 1 - j])
        core_re = core_re.at[..., j].add(
            seg_re[..., n_extra + code_len + j])
        core_im = core_im.at[..., j].add(
            seg_im[..., n_extra + code_len + j])

    corr_re = jnp.sum(core_re * code_table[..., None, :], axis=-1)
    corr_im = jnp.sum(core_im * code_table[..., None, :], axis=-1)
    return corr_re, corr_im
