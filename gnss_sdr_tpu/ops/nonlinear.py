"""Nonlinear Bayesian filters: cubature / unscented KF + NIW estimator.

Counterparts of the reference's nonlinear tracking library
(reference: src/algorithms/tracking/libs/nonlinear_tracking.{h,cc} —
``CubatureFilter`` / ``UnscentedFilter`` — and bayesian_estimation.{h,cc}
— normal-inverse-Wishart sequential covariance estimation, used by the
Gaussian tracking variant gps_l1_ca_gaussian_tracking).

Array-program shape: the filters are pure functions over (mean, covariance)
pytrees with user-supplied transition/measurement callables, written in
jax.numpy so they jit and ``vmap`` over the channel axis — the per-channel
Armadillo loops of the reference become one batched program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: full-precision products: a GPU may otherwise run float32 in TF32
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _chol_psd(p):
    """Cholesky with a small jitter for numerical PSD safety."""
    n = p.shape[-1]
    return jnp.linalg.cholesky(p + 1e-12 * jnp.eye(n, dtype=p.dtype))


# ---------------------------------------------------------------------------
# Cubature Kalman filter (3rd-degree spherical-radial rule, 2n points)
# ---------------------------------------------------------------------------


def cubature_points(x, p):
    """[2n, n] cubature points xi = x +- sqrt(n)*chol(P) columns."""
    n = x.shape[-1]
    s = _chol_psd(p) * jnp.sqrt(jnp.asarray(n, dtype=x.dtype))
    pts = jnp.concatenate([x[None, :] + s.T, x[None, :] - s.T], axis=0)
    return pts


def cubature_predict(f, x, p, q):
    """(x_pred, P_pred) through transition f: R^n -> R^n."""
    pts = cubature_points(x, p)
    fpts = jnp.stack([f(pt) for pt in pts]) if not callable(
        getattr(f, "vmapped", None)) else f(pts)
    x_pred = jnp.mean(fpts, axis=0)
    d = fpts - x_pred[None, :]
    p_pred = _mm(d.T, d) / fpts.shape[0] + q
    return x_pred, p_pred


def cubature_update(h, x_pred, p_pred, z, r):
    """Measurement update with h: R^n -> R^m. Returns (x, P)."""
    pts = cubature_points(x_pred, p_pred)
    zpts = jnp.stack([h(pt) for pt in pts])
    z_pred = jnp.mean(zpts, axis=0)
    dz = zpts - z_pred[None, :]
    dx = pts - x_pred[None, :]
    p_zz = _mm(dz.T, dz) / zpts.shape[0] + r
    p_xz = _mm(dx.T, dz) / zpts.shape[0]
    k = jnp.linalg.solve(p_zz.T, p_xz.T).T
    x = x_pred + _mm(k, jnp.atleast_1d(z) - z_pred)
    p = p_pred - _mm(_mm(k, p_zz), k.T)
    return x, p


class CubatureFilter:
    """Stateful convenience wrapper (reference CubatureFilter API)."""

    def __init__(self, x0, p0):
        self.x = jnp.asarray(x0, dtype=jnp.float64 if jnp.asarray(
            x0).dtype == jnp.float64 else jnp.float32)
        self.p = jnp.asarray(p0, dtype=self.x.dtype)

    def predict_sequential(self, f, q):
        self.x, self.p = cubature_predict(f, self.x, self.p, jnp.asarray(q))
        return self.x, self.p

    def update_sequential(self, h, z, r):
        self.x, self.p = cubature_update(h, self.x, self.p,
                                         jnp.asarray(z), jnp.asarray(r))
        return self.x, self.p


# ---------------------------------------------------------------------------
# Unscented Kalman filter (2n+1 sigma points)
# ---------------------------------------------------------------------------


def sigma_points(x, p, alpha=1.0, beta=2.0, kappa=0.0):
    # alpha=1 keeps the sigma weights O(1) — required in float32 (the
    # textbook 1e-3 produces +-1e6 weights that cancel catastrophically)
    """([2n+1, n] points, mean weights, covariance weights)."""
    n = x.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    s = _chol_psd(p) * jnp.sqrt(jnp.asarray(n + lam, dtype=x.dtype))
    pts = jnp.concatenate([x[None, :], x[None, :] + s.T, x[None, :] - s.T],
                          axis=0)
    wm = jnp.full(2 * n + 1, 1.0 / (2 * (n + lam)), dtype=x.dtype)
    wm = wm.at[0].set(lam / (n + lam))
    wc = wm.at[0].set(lam / (n + lam) + 1 - alpha * alpha + beta)
    return pts, wm, wc


def unscented_predict(f, x, p, q, **sp_kw):
    pts, wm, wc = sigma_points(x, p, **sp_kw)
    fpts = jnp.stack([f(pt) for pt in pts])
    x_pred = jnp.sum(wm[:, None] * fpts, axis=0)
    d = fpts - x_pred[None, :]
    p_pred = _mm((wc[:, None] * d).T, d) + q
    return x_pred, p_pred


def unscented_update(h, x_pred, p_pred, z, r, **sp_kw):
    pts, wm, wc = sigma_points(x_pred, p_pred, **sp_kw)
    zpts = jnp.stack([h(pt) for pt in pts])
    z_pred = jnp.sum(wm[:, None] * zpts, axis=0)
    dz = zpts - z_pred[None, :]
    dx = pts - x_pred[None, :]
    p_zz = _mm((wc[:, None] * dz).T, dz) + r
    p_xz = _mm((wc[:, None] * dx).T, dz)
    k = jnp.linalg.solve(p_zz.T, p_xz.T).T
    x = x_pred + _mm(k, jnp.atleast_1d(z) - z_pred)
    p = p_pred - _mm(_mm(k, p_zz), k.T)
    return x, p


class UnscentedFilter:
    def __init__(self, x0, p0, alpha=1.0, beta=2.0, kappa=0.0):
        self.x = jnp.asarray(x0)
        self.p = jnp.asarray(p0)
        self._kw = dict(alpha=alpha, beta=beta, kappa=kappa)

    def predict_sequential(self, f, q):
        self.x, self.p = unscented_predict(f, self.x, self.p,
                                           jnp.asarray(q), **self._kw)
        return self.x, self.p

    def update_sequential(self, h, z, r):
        self.x, self.p = unscented_update(h, self.x, self.p,
                                          jnp.asarray(z), jnp.asarray(r),
                                          **self._kw)
        return self.x, self.p


# ---------------------------------------------------------------------------
# Normal-inverse-Wishart sequential mean/covariance estimation
# ---------------------------------------------------------------------------


class BayesianEstimator:
    """Sequential conjugate (NIW) estimation of a measurement mean and
    covariance (Bayesian_estimator counterpart, bayesian_estimation.cc:
    posterior mu = (kappa*mu0 + n*xbar)/(kappa+n), Psi accumulation)."""

    def __init__(self, mu_prior, kappa_prior: int, nu_prior: int, psi_prior):
        self.mu_prior = jnp.asarray(mu_prior, dtype=jnp.float64)
        self.kappa = int(kappa_prior)
        self.nu = int(nu_prior)
        self.psi_prior = jnp.asarray(psi_prior, dtype=jnp.float64)
        ny = self.mu_prior.shape[0]
        self.mu_est = self.mu_prior
        self.psi_est = self.psi_prior / max(self.nu + ny + 1, 1)
        self._n = 0
        self._sum = jnp.zeros_like(self.mu_prior)
        self._outer = jnp.zeros_like(self.psi_prior)

    def update_sequential(self, data) -> None:
        y = jnp.asarray(data, dtype=jnp.float64)
        self._n += 1
        self._sum = self._sum + y
        self._outer = self._outer + jnp.outer(y, y)
        n = self._n
        xbar = self._sum / n
        scatter = self._outer - n * jnp.outer(xbar, xbar)
        kappa_post = self.kappa + n
        nu_post = self.nu + n
        mu_post = (self.kappa * self.mu_prior + n * xbar) / kappa_post
        dm = xbar - self.mu_prior
        psi_post = (self.psi_prior + scatter
                    + (self.kappa * n / kappa_post) * jnp.outer(dm, dm))
        ny = y.shape[0]
        self.mu_est = mu_post
        # inverse-Wishart mean when proper, reference fallback otherwise
        # (bayesian_estimation.cc:116-123)
        if nu_post - ny - 1 > 0:
            self.psi_est = psi_post / (nu_post - ny - 1)
        else:
            self.psi_est = psi_post / (nu_post + ny + 1)

    def get_mu_est(self):
        return self.mu_est

    def get_psi_est(self):
        return self.psi_est
