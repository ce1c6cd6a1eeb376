"""Gaussian carrier tracking: Kalman phase filter + Bayesian adaptive R.

Counterpart of the reference's ``GPS_L1_CA_Gaussian_Tracking`` block
(reference: src/algorithms/tracking/gnuradio_blocks/
gps_l1_ca_gaussian_tracking_cc.cc:652-760 — DLL code loop plus an order
2/3 carrier-phase Kalman filter whose measurement is the two-quadrant
atan phase discriminator, with optional normal-inverse-Wishart sequential
estimation of the measurement covariance, bayesian_estimation.cc:88-130;
adapter defaults at adapters/gps_l1_ca_gaussian_tracking.cc:56-60).

Array-program shape: an *error-state* filter. The reference keeps the
absolute accumulated carrier phase in ``kf_x(0)`` and copies it into the
NCO remnant each period; unbounded phase is hostile to float32, so here
the phase state carries only the not-yet-applied correction — the step
returns the phase increment to fold into the NCO remnant (mod 2pi on the
carry) and resets the phase state to zero. All algebra is written out in
jnp over a ``[..., n]`` state so one call closes every channel's loop.
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
class GaussianConfig:
    """Knobs of the Gaussian tracking loop (reference ctor + adapter)."""

    order: int = 3                 # 2 = phase/Doppler, 3 = +Doppler rate
    # Bayesian covariance estimation (reference bce_* properties)
    bayes_run: bool = True
    p_transient: int = 20          # KF iterations before NIW updates start
    s_transient: int = 50          # further iterations before R_est is used
    bce_kappa: int = 0
    bce_nu: int = 0
    # initial-uncertainty priors (gps_l1_ca_gaussian_tracking_cc.cc:171-175)
    sigma2_phase: float = TWO_PI / 4.0        # [rad^2]
    sigma2_doppler: float = 450.0             # [Hz^2]
    sigma2_doppler_rate: float = (4.0 * TWO_PI) ** 2 / 12.0  # [Hz^2/s^2]
    init_cn0_db_hz: float = 30.0


class GaussState(NamedTuple):
    """Carrier-KF + NIW carry; all fields support a leading channel axis."""

    x: jnp.ndarray        # [..., order] (phase err [rad], Doppler [Hz], rate)
    p: jnp.ndarray        # [..., order, order]
    niw_iter: jnp.ndarray  # [...] int32 KF iterations since (re)init
    niw_n: jnp.ndarray    # [...] int32 NIW observation count
    niw_mu: jnp.ndarray   # [...] float32 posterior measurement mean
    niw_psi: jnp.ndarray  # [...] float32 posterior scatter


def phase_detector_variance(cn0_db_hz, t: float):
    """sigma^2 of the atan phase detector [rad^2] at C/N0 and coherent T
    (gps_l1_ca_gaussian_tracking_cc.cc:675-677)."""
    cn_lin = jnp.power(10.0, jnp.asarray(cn0_db_hz, jnp.float32) / 10.0)
    g = 1.0 / (2.0 * cn_lin * jnp.float32(t))
    return g * (1.0 + g)


def _p_ini(cfg: GaussianConfig) -> np.ndarray:
    d = [cfg.sigma2_phase, cfg.sigma2_doppler]
    if cfg.order == 3:
        d.append(cfg.sigma2_doppler_rate)
    return np.diag(np.asarray(d, dtype=np.float32))


def gaussian_init(doppler_hz, cfg: GaussianConfig, t: float) -> GaussState:
    """Fresh per-channel state at tracking start. ``doppler_hz`` may be
    scalar or [C]; ``t`` is the coherent integration period [s]."""
    if cfg.order not in (2, 3):
        raise ValueError("order must be 2 or 3")
    dop = jnp.asarray(doppler_hz, jnp.float32)
    zeros = jnp.zeros_like(dop)
    cols = [zeros, dop] + ([zeros] if cfg.order == 3 else [])
    x = jnp.stack(cols, axis=-1)
    p = jnp.broadcast_to(jnp.asarray(_p_ini(cfg)),
                         x.shape[:-1] + (cfg.order, cfg.order))
    # Psi prior = (H P_ini H^T + R(30 dBHz)) * (nu + 2)  (ctor :228)
    r30 = float(phase_detector_variance(cfg.init_cn0_db_hz, t))
    psi0 = (float(cfg.sigma2_phase) + r30) * (cfg.bce_nu + 2.0)
    return GaussState(
        x=x, p=p,
        niw_iter=jnp.zeros_like(dop, dtype=jnp.int32),
        niw_n=jnp.zeros_like(dop, dtype=jnp.int32),
        niw_mu=zeros,
        niw_psi=jnp.full_like(dop, psi0),
    )


def _transition(cfg: GaussianConfig, t: float) -> np.ndarray:
    """F per gps_l1_ca_gaussian_tracking_cc.cc:187-216."""
    if cfg.order == 2:
        return np.asarray([[1.0, TWO_PI * t], [0.0, 1.0]], dtype=np.float32)
    return np.asarray([
        [1.0, TWO_PI * t, 0.5 * TWO_PI * t * t],
        [0.0, 1.0, t],
        [0.0, 0.0, 1.0]], dtype=np.float32)


def _process_noise(cfg: GaussianConfig, t: float) -> np.ndarray:
    """Q = diag(T^4, T[, T]) (ctor :183-209)."""
    d = [t ** 4, t] + ([t] if cfg.order == 3 else [])
    return np.diag(np.asarray(d, dtype=np.float32))


def gaussian_step(state: GaussState, phase_err_rad, cn0_db_hz, t: float,
                  cfg: GaussianConfig):
    """One carrier-KF iteration for all channels.

    Returns ``(new_state, info)`` where ``info`` carries:

    - ``phase_corr_rad`` — phase increment to add to the NCO remnant
      *beyond* the nominal Doppler rotation (the applied error estimate);
    - ``carrier_doppler_hz`` / ``doppler_rate_hz_s`` — filtered rates;
    - ``r_est`` — the measurement variance in use (reference
      ``kf_R_est``, dumped as carr_phase_sigma2).
    """
    y = jnp.asarray(phase_err_rad, jnp.float32)
    f = jnp.asarray(_transition(cfg, t))
    q = jnp.asarray(_process_noise(cfg, t))

    # predict. The NCO already rotates by 2*pi*f_hat*T (row 0 of F applied
    # to the Doppler state), so the *unapplied* phase error propagates
    # only through terms the NCO does not model: here, none beyond the
    # existing error itself (rate enters Doppler first). Covariance uses
    # the full F — the phase/Doppler cross terms are what give the filter
    # its frequency-pull.
    x_pre = jnp.einsum("ij,...j->...i", f, state.x, precision=_HIGHEST)
    x_pre = x_pre.at[..., 0].set(state.x[..., 0])  # NCO models the rotation
    p_pre = jnp.einsum("ij,...jk,lk->...il", f, state.p, f,
                       precision=_HIGHEST) + q

    # measurement noise from the current C/N0 estimate (:675-678)
    r = phase_detector_variance(cn0_db_hz, t)

    # --- NIW sequential covariance estimation (bayesian_estimation.cc:88)
    it = state.niw_iter
    do_upd = jnp.asarray(cfg.bayes_run) & (it >= cfg.p_transient)
    kappa_t = (cfg.bce_kappa + state.niw_n).astype(jnp.float32)
    nu_t = (cfg.bce_nu + state.niw_n).astype(jnp.float32)
    mu_new = (kappa_t * state.niw_mu + y) / (kappa_t + 1.0)
    psi_new = state.niw_psi + kappa_t / (kappa_t + 1.0) \
        * (y - state.niw_mu) ** 2
    niw_n = jnp.where(do_upd, state.niw_n + 1, state.niw_n)
    niw_mu = jnp.where(do_upd, mu_new, state.niw_mu)
    niw_psi = jnp.where(do_upd, psi_new, state.niw_psi)
    nu_post = (cfg.bce_nu + niw_n).astype(jnp.float32)
    # ny=1: divide by nu-2 once proper, else nu+2 (bayesian_estimation.cc:117)
    psi_est = niw_psi / jnp.where(nu_post - 2.0 > 0.0,
                                  nu_post - 2.0, nu_post + 2.0)

    hph = p_pre[..., 0, 0]
    use_bayes = jnp.asarray(cfg.bayes_run) \
        & (it >= cfg.p_transient + cfg.s_transient)
    p_y = jnp.where(use_bayes, jnp.maximum(psi_est, 1e-12), hph + r)
    r_est = jnp.where(use_bayes, jnp.maximum(psi_est - hph, 1e-12), r)

    # --- update: K = P H^T / P_y with H = [1, 0(, 0)]
    k = p_pre[..., :, 0] / p_y[..., None]          # [..., order]
    x_new = x_pre + k * y[..., None]
    # P = (I - K H) P_pre : subtract outer(K, row0(P_pre))
    p_new = p_pre - k[..., :, None] * p_pre[..., 0, :][..., None, :]

    phase_corr = x_new[..., 0]
    x_out = x_new.at[..., 0].set(0.0)              # error-state reset
    info = dict(
        phase_corr_rad=phase_corr,
        carrier_doppler_hz=x_new[..., 1],
        doppler_rate_hz_s=(x_new[..., 2] if cfg.order == 3
                           else jnp.zeros_like(phase_corr)),
        r_est=r_est,
    )
    new = GaussState(x=x_out, p=p_new, niw_iter=it + 1,
                     niw_n=niw_n, niw_mu=niw_mu, niw_psi=niw_psi)
    return new, info
