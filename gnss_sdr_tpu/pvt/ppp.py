"""Precise Point Positioning: float-ambiguity EKF on iono-free
code + carrier with precise products.

Counterpart of the reference's PPP estimator
(/root/reference/src/algorithms/libs/rtklib/rtklib_ppp.cc): the roles of
``pppos`` :1769 (epoch driver), ``udstate_ppp`` :1464 (time update of
position/clock/troposphere/ambiguity states), ``ifmeas`` :945 (iono-free
combination), ``corr_ion``/``corrmeas`` :1059-1180 (single-frequency
ionosphere-corrected fallback via TEC maps), ``prectrop`` :1515
(hydrostatic model + estimated zenith wet delay with an elevation
mapping), ``res_ppp`` :1550 (measurement residuals + innovation
screening) and ``detslp_gf``/``detslp_ll`` :1300-1360 (cycle-slip
detection resetting ambiguity states). Solid-earth tide displacement of
the receiver is modeled via :mod:`gnss_sdr_tpu.pvt.tides`
(rtklib_tides.cc), satellite orbits/clocks come from broadcast or SP3
(:mod:`gnss_sdr_tpu.pvt.precise`).

Design: a plain dense-EKF in NumPy — the state is tiny (4 + 1 + #sats),
epochs arrive at 0.1-30 s cadence, so this is host control-plane math
like the rest of the PVT block; the accelerator serves the signal plane.

Out of scope (documented divergences): receiver/satellite antenna PCVs
and phase windup (need ANTEX inputs; the reference skips them too
without files), ambiguity resolution (rtklib_ppp's fix_amb_* operate on
the float solution this module produces; `pvt/rtk.py` carries the
LAMBDA machinery).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from gnss_sdr_tpu.constants.general import SPEED_OF_LIGHT_M_S as C
from gnss_sdr_tpu.pvt import atmosphere, geodesy
from gnss_sdr_tpu.pvt.solver import _geodist
from gnss_sdr_tpu.pvt.tides import tidedisp

F_L1 = 1575.42e6
F_L2 = 1227.60e6
F_L5 = 1176.45e6


@dataclasses.dataclass
class PppObservation:
    """Dual-frequency code+carrier measurement of one satellite.

    ``l1_cycles``/``l2_cycles`` are accumulated carrier phases in cycles
    (ambiguous); single-frequency callers leave the 2-channel fields
    None and must configure a TEC map (corr_ion role)."""

    prn: int
    eph: object                    # sat_pos/clock_bias_s provider
    p1_m: float
    l1_cycles: float
    f1_hz: float = F_L1
    p2_m: float | None = None
    l2_cycles: float | None = None
    f2_hz: float = F_L2
    cn0_db_hz: float = 45.0


@dataclasses.dataclass
class PppConfig:
    sigma_code_m: float = 0.3          # iono-free code sigma at zenith
    sigma_phase_m: float = 0.003       # iono-free carrier sigma
    zwd_process_m: float = 1e-4        # ZWD random walk /sqrt(s)
    pos_process_m: float = 0.0         # 0 = static mode (PPP_Static)
    amb_init_var_m2: float = 400.0
    zwd_init_var_m2: float = 0.25
    slip_gf_threshold_m: float = 0.05  # geometry-free jump -> slip
    elevation_mask_rad: float = math.radians(7.0)
    innovation_limit_m: float = 30.0
    apply_tides: bool = True
    tec: object | None = None          # IonexTec for single-freq mode


@dataclasses.dataclass
class PppSolution:
    valid: bool
    pos_ecef: np.ndarray
    clock_bias_m: float
    zwd_m: float
    n_sats: int
    sigma_pos_m: float
    residuals_m: np.ndarray
    ambiguities_m: dict[int, float]


def iono_free(v1: float, v2: float, f1: float, f2: float) -> float:
    """Iono-free linear combination (ifmeas/L_LC/P_LC roles)."""
    g = f1 * f1 / (f2 * f2)
    return (g * v1 - v2) / (g - 1.0)


class PppEngine:
    """Sequential float-PPP filter; one :meth:`process_epoch` per
    observation epoch."""

    def __init__(self, cfg: PppConfig, x0_ecef=None):
        self.cfg = cfg
        self.x: np.ndarray | None = None     # [x y z clk zwd]
        self.p: np.ndarray | None = None
        self.amb: dict[int, int] = {}        # prn -> state index
        self._amb_uninit: set = set()        # prns pending code-carrier init
        self.last_gf: dict[int, float] = {}  # geometry-free carrier [m]
        self.last_t: float | None = None
        self.solutions: list[PppSolution] = []
        self._x0 = None if x0_ecef is None else np.asarray(x0_ecef, float)

    # -- state bookkeeping -------------------------------------------------
    def _n_base(self) -> int:
        return 5

    def _ensure_states(self, obs: list[PppObservation]) -> None:
        nb = self._n_base()
        if self.x is None:
            x0 = np.zeros(nb)
            if self._x0 is not None:
                x0[:3] = self._x0
            self.x = x0
            p = np.zeros((nb, nb))
            p[:3, :3] = np.eye(3) * 1e8
            p[3, 3] = 1e10
            p[4, 4] = self.cfg.zwd_init_var_m2
            self.p = p
        for o in obs:
            if o.prn not in self.amb:
                i = len(self.x)
                self.amb[o.prn] = i
                self._amb_uninit.add(o.prn)
                self.x = np.append(self.x, 0.0)
                p = np.zeros((i + 1, i + 1))
                p[:i, :i] = self.p
                p[i, i] = self.cfg.amb_init_var_m2
                self.p = p

    def _reset_amb(self, prn: int) -> None:
        i = self.amb[prn]
        self.x[i] = 0.0
        self.p[i, :] = 0.0
        self.p[:, i] = 0.0
        self.p[i, i] = self.cfg.amb_init_var_m2
        self._amb_uninit.add(prn)

    def _time_update(self, t: float) -> None:
        if self.last_t is None:
            self.last_t = t
            return
        dt = max(t - self.last_t, 0.0)
        self.last_t = t
        q = np.zeros_like(self.p)
        q[0, 0] = q[1, 1] = q[2, 2] = (self.cfg.pos_process_m ** 2) * dt
        q[4, 4] = (self.cfg.zwd_process_m ** 2) * dt
        self.p = self.p + q
        # receiver clock as white noise: re-initialized every epoch
        # (udclk_ppp :1233-1256) — robust to free-running oscillator
        # drift and millisecond clock jumps
        self.p[3, :] = 0.0
        self.p[:, 3] = 0.0
        self.p[3, 3] = 1e10

    # -- measurement model -------------------------------------------------
    def _detect_slips(self, obs: list[PppObservation]) -> None:
        """Geometry-free carrier jump test (detslp_gf :1325-1360)."""
        for o in obs:
            if o.l2_cycles is None:
                continue
            gf = (C / o.f1_hz) * o.l1_cycles - (C / o.f2_hz) * o.l2_cycles
            prev = self.last_gf.get(o.prn)
            self.last_gf[o.prn] = gf
            if prev is not None and \
                    abs(gf - prev) > self.cfg.slip_gf_threshold_m \
                    and o.prn in self.amb:
                self._reset_amb(o.prn)

    def process_epoch(self, t: float, obs: list[PppObservation]
                      ) -> PppSolution:
        cfg = self.cfg
        self._ensure_states(obs)
        self._time_update(t)
        self._detect_slips(obs)
        x, p = self.x, self.p
        n = len(x)
        rr = x[:3].copy()
        crude = bool(np.all(rr == 0.0))
        disp = np.zeros(3)
        if cfg.apply_tides and not crude:
            disp = tidedisp(t, rr)
        rows_h, rows_v, rows_r, used = [], [], [], []
        lat, lon, hgt = geodesy.ecef_to_geodetic(rr + disp) if not crude \
            else (0.0, 0.0, 0.0)
        for o in obs:
            t_tx = t - o.p1_m / C
            dts = o.eph.clock_bias_s(t_tx)
            sat = np.asarray(o.eph.sat_pos(t_tx - dts))
            rho, los = _geodist(sat, rr + disp)
            if not crude:
                _az, el = geodesy.azimuth_elevation(rr + disp, sat)
                if el < cfg.elevation_mask_rad:
                    continue
            else:
                _az, el = 0.0, math.pi / 2.0
            # troposphere: hydrostatic model + estimated wet along the
            # mapping (prectrop :1515-1547)
            m_w = 1.0 / max(math.sin(el), 0.05)
            trop_h = atmosphere.saastamoinen_delay(lat, hgt, el,
                                                   humidity=0.0) \
                if not crude else 0.0
            if o.p2_m is not None:
                pr = iono_free(o.p1_m, o.p2_m, o.f1_hz, o.f2_hz)
                ph = iono_free((C / o.f1_hz) * o.l1_cycles,
                               (C / o.f2_hz) * o.l2_cycles,
                               o.f1_hz, o.f2_hz)
                iono = 0.0
            else:
                # single-frequency: TEC-map slant correction (corr_ion)
                pr, ph = o.p1_m, (C / o.f1_hz) * o.l1_cycles
                iono = 0.0
                if cfg.tec is not None and not crude:
                    iono = cfg.tec.slant_delay_m(
                        t, (lat, lon, hgt), _az, el, o.f1_hz)
            base = rho + x[3] - C * dts + trop_h + x[4] * m_w
            i_amb = self.amb[o.prn]
            if o.prn in self._amb_uninit and not crude:
                # seed the ambiguity from code-minus-carrier so the first
                # phase innovation is noise-sized, not range-sized
                # (udbias_ppp :1361-1461 initialization); the +2*iono
                # restores the sign-opposite iono of the single-frequency
                # pair (zero in the iono-free case)
                x[i_amb] = ph - pr + 2.0 * iono
                self._amb_uninit.discard(o.prn)
            # code row
            rows_h.append((los, m_w, None))
            rows_v.append(pr - (base + iono))
            rows_r.append(cfg.sigma_code_m ** 2 * (1.0
                          + 1.0 / max(math.sin(el), 0.1) ** 2))
            # carrier row (ambiguity state in meters)
            rows_h.append((los, m_w, i_amb))
            rows_v.append(ph - (base - iono + x[i_amb]))
            rows_r.append(cfg.sigma_phase_m ** 2 * (1.0
                          + 1.0 / max(math.sin(el), 0.1) ** 2))
            used.append(o.prn)
        if len(used) < 4 and not crude:
            sol = PppSolution(False, rr, x[3], x[4], len(used), 1e9,
                              np.zeros(0), {})
            self.solutions.append(sol)
            return sol
        m = len(rows_v)
        h = np.zeros((m, n))
        for r, (los, m_w, i_amb) in enumerate(rows_h):
            h[r, 0:3] = -los
            h[r, 3] = 1.0
            h[r, 4] = m_w
            if i_amb is not None:
                h[r, i_amb] = 1.0
        v = np.asarray(rows_v)
        rm = np.diag(rows_r)
        if crude:
            # bootstrap: iterative code-only least squares (relinearized
            # each pass, pntpos role) seeds position+clock, then the
            # epoch re-runs as a normal filter update
            for _ in range(10):
                rows = []
                vals = []
                for o in obs:
                    t_tx = t - o.p1_m / C
                    dts = o.eph.clock_bias_s(t_tx)
                    sat = np.asarray(o.eph.sat_pos(t_tx - dts))
                    rho, los = _geodist(sat, x[:3])
                    rows.append(np.concatenate([-los, [1.0]]))
                    vals.append(o.p1_m - (rho + x[3] - C * dts))
                dx, *_ = np.linalg.lstsq(
                    np.asarray(rows), np.asarray(vals), rcond=None)
                x[:3] += dx[:3]
                x[3] += dx[3]
                if np.linalg.norm(dx[:3]) < 1e-4:
                    break
            return self.process_epoch(t, obs)
        # innovation screening (res_ppp post-fit test role)
        keep = np.abs(v) < cfg.innovation_limit_m
        h, v, rm = h[keep], v[keep], rm[np.ix_(keep, keep)]
        s = h @ p @ h.T + rm
        k = p @ h.T @ np.linalg.inv(s)
        self.x = x + k @ v
        ikh = np.eye(n) - k @ h
        # Joseph form keeps P symmetric positive with the tiny phase R
        self.p = ikh @ p @ ikh.T + k @ rm @ k.T
        sol = PppSolution(
            True, self.x[:3].copy(), self.x[3], self.x[4], len(used),
            float(np.sqrt(np.trace(self.p[:3, :3]))), v,
            {prn: float(self.x[i]) for prn, i in self.amb.items()})
        self.solutions.append(sol)
        return sol
