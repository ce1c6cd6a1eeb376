"""Kalman-filter carrier/code tracking (KF variant).

Counterpart of the reference's ``kf_tracking`` block
(/root/reference/src/algorithms/tracking/gnuradio_blocks/kf_tracking.cc,
run_Kf :1129-1166, GPS_L1_CA_KF_Tracking adapter): a 4-state filter

    x = [code_phase_chips, carrier_phase_rad, carrier_doppler_hz,
         doppler_rate_hz_s]

propagated per integration interval T and corrected by the DLL/PLL
discriminator outputs (code-phase error [chips], carrier-phase error
[rad]). The reference builds its matrices with Armadillo; here the 4x4
algebra is written out explicitly in jnp so it vmaps over channels and
runs inside the tracking scan.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class KfConfig:
    chip_rate_cps: float = 1.023e6
    carrier_hz: float = 1575.42e6
    # process noise PSDs (reference kf_conf defaults' roles)
    q_code: float = 1e-4         # code phase random walk [chips^2/s]
    q_phase: float = 1e-2        # carrier phase [rad^2/s]
    q_doppler: float = 1.0       # Doppler random walk [Hz^2/s]
    q_doppler_rate: float = 1e-1  # Doppler-rate random walk [Hz^2/s^3]
    r_code: float = 1e-2         # code discriminator variance [chips^2]
    r_phase: float = 0.05        # phase discriminator variance [rad^2]


class KfState(NamedTuple):
    x: jnp.ndarray   # [..., 4]
    p: jnp.ndarray   # [..., 4, 4]


def kf_init(code_phase_chips, carrier_phase_rad, doppler_hz,
            p0=(1.0, 10.0, 100.0, 10.0)) -> KfState:
    x = jnp.stack([
        jnp.asarray(code_phase_chips, jnp.float32),
        jnp.asarray(carrier_phase_rad, jnp.float32),
        jnp.asarray(doppler_hz, jnp.float32),
        jnp.zeros_like(jnp.asarray(doppler_hz, jnp.float32)),
    ], axis=-1)
    p = jnp.diag(jnp.asarray(p0, jnp.float32))
    p = jnp.broadcast_to(p, x.shape[:-1] + (4, 4))
    return KfState(x=x, p=p)


def _transition(cfg: KfConfig, t: float):
    """F (4x4) with code-carrier coupling (Doppler drives both phases)."""
    beta = cfg.chip_rate_cps / cfg.carrier_hz  # chips per carrier cycle
    f = np.eye(4, dtype=np.float32)
    f[0, 2] = beta * t                 # code phase <- Doppler [Hz]*t cycles
    f[0, 3] = 0.5 * beta * t * t
    f[1, 2] = TWO_PI * t               # carrier phase <- Doppler
    f[1, 3] = np.pi * t * t
    f[2, 3] = t
    return f


def _process_noise(cfg: KfConfig, t: float):
    return np.diag(np.asarray([
        cfg.q_code * t, cfg.q_phase * t, cfg.q_doppler * t,
        cfg.q_doppler_rate * t], dtype=np.float32))


def kf_step(state: KfState, code_err_chips, phase_err_rad, t: float,
            cfg: KfConfig):
    """One predict+update; measurements are the discriminator errors
    (innovations) relative to the propagated state. Returns the new state;
    x holds the corrected absolute phases/Doppler."""
    f = jnp.asarray(_transition(cfg, t))
    q = jnp.asarray(_process_noise(cfg, t))
    x_pred = jnp.einsum("ij,...j->...i", f, state.x, precision=_HIGHEST)
    p_pred = jnp.einsum("ij,...jk,lk->...il", f, state.p, f,
                        precision=_HIGHEST) + q

    # H selects code phase and carrier phase; the discriminators ARE the
    # innovations y = z - Hx (they measure error vs the local replica)
    y = jnp.stack([jnp.asarray(code_err_chips, jnp.float32),
                   jnp.asarray(phase_err_rad, jnp.float32)], axis=-1)
    r = jnp.asarray(np.diag([cfg.r_code, cfg.r_phase]).astype(np.float32))
    h_rows = (0, 1)
    ph = p_pred[..., :, h_rows]                     # [..., 4, 2]
    s = p_pred[..., h_rows, :][..., :, h_rows] + r  # [..., 2, 2]
    # closed-form 2x2 inverse
    det = s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]
    inv = jnp.stack([
        jnp.stack([s[..., 1, 1], -s[..., 0, 1]], axis=-1),
        jnp.stack([-s[..., 1, 0], s[..., 0, 0]], axis=-1),
    ], axis=-2) / det[..., None, None]
    k = jnp.einsum("...ij,...jk->...ik", ph, inv,
                   precision=_HIGHEST)              # [..., 4, 2]
    delta = jnp.einsum("...ij,...j->...i", k, y,
                       precision=_HIGHEST)          # measurement correction
    x_new = x_pred + delta
    kh = jnp.zeros_like(p_pred).at[..., :, 0].set(k[..., :, 0]) \
        .at[..., :, 1].set(k[..., :, 1])
    p_new = p_pred - jnp.einsum("...ij,...jk->...ik", kh, p_pred,
                                precision=_HIGHEST)
    return KfState(x=x_new, p=p_new), delta
