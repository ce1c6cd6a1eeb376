"""Fast steady-state tracking engine: group-batched correlation.

The scan engine (engine.py) mirrors the reference's per-PRN-period
sequential pipeline exactly — necessary during pull-in and wide-band
tracking, but latency-bound: ~1000 tiny sequential scan steps per second
of signal. In *extended coherent integration* (the production steady state,
reference states 3/4), the loops close only once per K-period group, so
NCO parameters are constant inside a group. That makes the heavy work
embarrassingly parallel: all K periods of a group (and all channels)
correlate in ONE batched gather+rotate+reduce, with closed-form period
boundaries

    boundary_k = offset + rem0 + k * T_prn_samples   (exact v1 carry math:
    start_k = floor(boundary_k), rem_k = frac(boundary_k))

and only a cheap per-group scalar scan closes the DLL/PLL. Per second of
signal: ~50 loop steps instead of ~1000, with the same arithmetic as the
scan engine's extended mode (loop filters, discriminators, C/N0 — shared
ops modules).

Use: pull in and bit-sync with TrackingEngine, then hand the channel
state over (:func:`from_track_state`); the semantics match the scan
engine's extended mode.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sdr_tpu.ops import discriminators as disc
from gnss_sdr_tpu.ops import lock_detectors as lockdet
from gnss_sdr_tpu.ops import loop_filters as lf
from gnss_sdr_tpu.tracking.engine import TrackingConfig, TrackState

TWO_PI = 2.0 * math.pi

#: precision of the correlator contractions: full float32. A GPU may
#: otherwise run float32 products in TF32 (~3 decimal digits), below
#: what the loop discriminators and the bank-vs-segsum bounds assume.
PRECISION = jax.lax.Precision.HIGHEST

#: jitted program sets keyed by (config, channels, groups, correlator,
#: loop) — shared across engine instances (see TrackingEngine)
_PROGRAM_CACHE: dict = {}


class FastState(NamedTuple):
    """Per-channel carry for the group-batched engine ([C] leading dim)."""

    active: jax.Array
    offset: jax.Array              # int32 block-relative next group start
    rem_code_phase_samples: jax.Array
    rem_carr_phase_rad: jax.Array
    carrier_doppler_hz: jax.Array
    if_freq_hz: jax.Array          # per-channel IF offset (GLONASS FDMA
    #   slot carrier); carrier NCO adds it on top of the loop Doppler,
    #   loop state and Doppler/phase outputs exclude it (see TrackState)
    code_doppler_chips: jax.Array  # code freq minus nominal chip rate
    #   (offset form: absolute f32 code frequency has a 0.0625 cps LSB at
    #   1.023e6 which limit-cycles the DLL at meter level)
    carr_w: jax.Array
    carr_x: jax.Array
    code_x_hist: jax.Array
    code_y_hist: jax.Array
    p_old_re: jax.Array
    p_old_im: jax.Array
    prompt_buf_re: jax.Array
    prompt_buf_im: jax.Array
    prompt_count: jax.Array
    cn0_db_hz: jax.Array
    carrier_lock_test: jax.Array
    code_lock_fail: jax.Array
    carrier_lock_fail: jax.Array
    loss_of_lock: jax.Array
    kf_x: jax.Array                # [C,4] error-state KF (loop="kf";
    #                                loop="gaussian" uses [:, 1:4])
    kf_p: jax.Array                # [C,4,4]
    gs_niw: jax.Array              # [C,4] (iter, n, mu, psi) NIW carry
    #                                for loop="gaussian"
    # pilot secondary-code wipe-off (L5 NH20 / E5a CS100 / E1-C CS25 /
    # B1I NH20 — dll_pll_veml_tracking.cc save_correlation_results
    # :1290): period j of a group is multiplied by
    # sec_signs[c, (sec_phase + j) % sec_len] before coherent group
    # accumulation; sec_len=1 with sign +1 disables (GPS L1 data case).
    sec_signs: jax.Array           # f32 [C, S]
    sec_len: jax.Array             # int32 [C]
    sec_phase: jax.Array           # int32 [C]: sec index of next period
    secondary_locked: jax.Array    # bool [C]: wiped -> 4-quadrant PLL


class FastTrackingEngine:
    """K-period group tracking over blocks of G groups.

    ``block_samples`` must cover G groups: G*K*T_prn plus margin; blocks
    overlap by ``overlap`` samples like the scan engine.
    """

    #: sub-sample phases in the code bank (``correlator="bank"``)
    BANK_PHASES = 16

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 groups_per_block: int = 5, correlator: str = "bank",
                 loop: str = "fllpll", kf_config=None,
                 sec_max_len: int = 1):
        if cfg.extend_correlation_symbols < 1:
            raise ValueError("extend_correlation_symbols must be >= 1")
        if correlator not in ("bank", "segsum"):
            raise ValueError("correlator must be 'bank' or 'segsum'")
        if loop not in ("fllpll", "kf", "gaussian"):
            raise ValueError("loop must be 'fllpll', 'kf' or 'gaussian'")
        self.loop = loop
        self._gs_psi0 = 0.0
        if loop == "kf":
            from gnss_sdr_tpu.ops.kalman import KfConfig

            self.kf_cfg = kf_config or KfConfig(
                chip_rate_cps=cfg.chip_rate_cps, carrier_hz=cfg.carrier_hz)
        elif loop == "gaussian":
            from gnss_sdr_tpu.ops.gaussian import (GaussianConfig,
                                                   phase_detector_variance)

            self.gs_cfg = kf_config or GaussianConfig()
            t_g = cfg.code_period_s * cfg.extend_correlation_symbols
            r30 = float(phase_detector_variance(
                self.gs_cfg.init_cn0_db_hz, t_g))
            self._gs_psi0 = (float(self.gs_cfg.sigma2_phase) + r30) \
                * (self.gs_cfg.bce_nu + 2.0)
        self.cfg = cfg
        self.n_channels = n_channels
        self.correlator = correlator
        self.k = cfg.extend_correlation_symbols
        self.g = groups_per_block
        spc = cfg.samples_per_code
        self.max_period = spc + 16
        self.block_samples = self.g * self.k * spc
        # per-period correlation window (bank mode), lane-aligned
        self.win_len = int(math.ceil((self.max_period + 127) / 128)) * 128
        if correlator == "bank":
            self.overlap = self.k * spc + self.win_len + 32
        else:
            self.overlap = self.k * spc + self.max_period
        self.n_taps = cfg.n_taps
        #: max secondary-code length handled on device (NH20=20, CS100=100,
        #: CS25=25); 1 = no wipe-off (GPS L1 C/A data tracking)
        self.sec_max_len = int(sec_max_len)
        self.track_pilot = bool(cfg.track_pilot)
        self._bank_cache: tuple[object, jax.Array] | None = None
        self._data_bank_cache: tuple[object, jax.Array] | None = None

        self._shifts = jnp.asarray(cfg.tap_shifts())
        self._gains = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_narrow_hz, cfg.pll_filter_order)
        ic, oc = lf.loop_filter_coefficients(
            cfg.code_period_s * self.k, cfg.dll_bw_narrow_hz,
            cfg.dll_filter_order, include_last_integrator=False)
        self._dll_ic = jnp.asarray(ic)
        self._dll_oc = jnp.asarray(oc)
        # share jitted programs across instances with equal configs (a
        # fresh receiver otherwise re-traces everything; seconds of host
        # time even with a warm XLA compile cache). Only cacheable with
        # the default loop configs (kf_config identity matters otherwise).
        key = None
        if kf_config is None:
            key = (dataclasses.astuple(cfg), n_channels, groups_per_block,
                   correlator, loop, self.sec_max_len)
        progs = _PROGRAM_CACHE.get(key) if key is not None else None
        if progs is None:
            block_step = jax.jit(self._build(), donate_argnums=(0,))
            progs = (block_step, self._superblock_step,
                     self._superblock_step_i8, self._superblock_ring_i8,
                     jax.jit(self._start_channel_impl))
            if key is not None:
                _PROGRAM_CACHE[key] = progs
        (self._block_step, self._superblock_step, self._superblock_step_i8,
         self._superblock_ring_i8, self._start_channel_jit) = progs

    # -- state ------------------------------------------------------------
    def _kf_p0(self) -> np.ndarray:
        """Initial 4x4 covariance slab; loop='gaussian' embeds the
        reference P_ini (phase/Doppler/rate) in the [1:,1:] block."""
        if self.loop == "gaussian":
            from gnss_sdr_tpu.ops.gaussian import _p_ini

            p = np.eye(4, dtype=np.float32)
            sub = _p_ini(self.gs_cfg)
            n = sub.shape[0]
            p[1:1 + n, 1:1 + n] = sub
            return p
        return np.diag(np.asarray([1.0, 10.0, 100.0, 10.0], np.float32))

    def _gs_niw0(self, shape) -> jnp.ndarray:
        z = np.zeros(shape + (4,), dtype=np.float32)
        z[..., 3] = self._gs_psi0
        return jnp.asarray(z)

    def init_state(self) -> FastState:
        c = self.n_channels
        f32 = functools.partial(jnp.zeros, (c,), dtype=jnp.float32)
        i32 = functools.partial(jnp.zeros, (c,), dtype=jnp.int32)
        return FastState(
            active=jnp.zeros((c,), dtype=bool), offset=i32(),
            rem_code_phase_samples=f32(), rem_carr_phase_rad=f32(),
            carrier_doppler_hz=f32(), if_freq_hz=f32(),
            code_doppler_chips=f32(),
            carr_w=f32(), carr_x=f32(),
            code_x_hist=jnp.zeros((c, lf.HISTORY), dtype=jnp.float32),
            code_y_hist=jnp.zeros((c, lf.HISTORY - 1), dtype=jnp.float32),
            p_old_re=f32(), p_old_im=f32(),
            prompt_buf_re=jnp.zeros((c, self.cfg.cn0_samples),
                                    dtype=jnp.float32),
            prompt_buf_im=jnp.zeros((c, self.cfg.cn0_samples),
                                    dtype=jnp.float32),
            prompt_count=i32(), cn0_db_hz=f32(), carrier_lock_test=f32(),
            code_lock_fail=i32(), carrier_lock_fail=i32(),
            loss_of_lock=jnp.zeros((c,), dtype=bool),
            kf_x=jnp.zeros((c, 4), dtype=jnp.float32),
            kf_p=jnp.broadcast_to(jnp.asarray(self._kf_p0()), (c, 4, 4)),
            gs_niw=self._gs_niw0((c,)),
            sec_signs=jnp.ones((c, self.sec_max_len), dtype=jnp.float32),
            sec_len=jnp.ones((c,), dtype=jnp.int32),
            sec_phase=jnp.zeros((c,), dtype=jnp.int32),
            secondary_locked=jnp.zeros((c,), dtype=bool),
        )

    def from_track_state(self, ts: TrackState) -> FastState:
        """Adopt a scan-engine state (after pull-in + bit sync; channel
        offsets must already be group/bit aligned)."""
        if self._gains.order == 3:
            w0 = jnp.zeros_like(ts.carrier_doppler_hz)
            x0 = 2.0 * ts.carrier_doppler_hz
        else:
            w0 = ts.carrier_doppler_hz
            x0 = jnp.zeros_like(ts.carrier_doppler_hz)
        return FastState(
            active=ts.active, offset=ts.offset,
            rem_code_phase_samples=ts.rem_code_phase_samples,
            rem_carr_phase_rad=ts.rem_carr_phase_rad,
            carrier_doppler_hz=ts.carrier_doppler_hz,
            if_freq_hz=ts.if_freq_hz,
            code_doppler_chips=ts.code_doppler_chips,
            carr_w=w0, carr_x=x0,
            code_x_hist=ts.code_x_hist, code_y_hist=ts.code_y_hist,
            p_old_re=ts.p_old_re, p_old_im=ts.p_old_im,
            prompt_buf_re=ts.prompt_buf_re, prompt_buf_im=ts.prompt_buf_im,
            prompt_count=ts.prompt_count, cn0_db_hz=ts.cn0_db_hz,
            carrier_lock_test=ts.carrier_lock_test,
            code_lock_fail=ts.code_lock_fail,
            carrier_lock_fail=ts.carrier_lock_fail,
            loss_of_lock=ts.loss_of_lock,
            kf_x=jnp.zeros(ts.carrier_doppler_hz.shape + (4,),
                           dtype=jnp.float32).at[:, 2].set(
                ts.carrier_doppler_hz),
            kf_p=jnp.broadcast_to(
                jnp.asarray(self._kf_p0()),
                ts.carrier_doppler_hz.shape + (4, 4)),
            gs_niw=self._gs_niw0(ts.carrier_doppler_hz.shape),
            sec_signs=jnp.ones(ts.carrier_doppler_hz.shape
                               + (self.sec_max_len,), dtype=jnp.float32),
            sec_len=jnp.ones(ts.carrier_doppler_hz.shape, dtype=jnp.int32),
            sec_phase=jnp.zeros(ts.carrier_doppler_hz.shape,
                                dtype=jnp.int32),
            secondary_locked=jnp.zeros(ts.carrier_doppler_hz.shape,
                                       dtype=bool),
        )

    def start_channel(self, state: FastState, ch: int, doppler_hz: float,
                      offset_samples: int,
                      if_freq_hz: float = 0.0) -> FastState:
        """One jitted program (ch traced) — see TrackingEngine.start_channel
        for why the eager .at[].set chain is too slow at cold start."""
        return self._start_channel_jit(
            state, jnp.int32(ch), jnp.float32(doppler_hz),
            jnp.int32(offset_samples), jnp.float32(if_freq_hz))

    def _start_channel_impl(self, state: FastState, ch, doppler_hz,
                            offset_samples, if_freq_hz) -> FastState:
        if self._gains.order == 3:
            w0, x0 = jnp.float32(0.0), 2.0 * doppler_hz
        else:
            w0, x0 = doppler_hz, jnp.float32(0.0)
        return state._replace(
            active=state.active.at[ch].set(True),
            offset=state.offset.at[ch].set(offset_samples),
            rem_code_phase_samples=state.rem_code_phase_samples.at[ch].set(0.0),
            rem_carr_phase_rad=state.rem_carr_phase_rad.at[ch].set(0.0),
            carrier_doppler_hz=state.carrier_doppler_hz.at[ch].set(doppler_hz),
            if_freq_hz=state.if_freq_hz.at[ch].set(if_freq_hz),
            code_doppler_chips=state.code_doppler_chips.at[ch].set(0.0),
            carr_w=state.carr_w.at[ch].set(w0),
            carr_x=state.carr_x.at[ch].set(x0),
            loss_of_lock=state.loss_of_lock.at[ch].set(False),
            kf_x=state.kf_x.at[ch].set(
                jnp.zeros((4,), jnp.float32).at[2].set(doppler_hz)),
            kf_p=state.kf_p.at[ch].set(jnp.asarray(self._kf_p0())),
            gs_niw=state.gs_niw.at[ch].set(self._gs_niw0(())),
            sec_signs=state.sec_signs.at[ch].set(1.0),
            sec_len=state.sec_len.at[ch].set(1),
            sec_phase=state.sec_phase.at[ch].set(0),
            secondary_locked=state.secondary_locked.at[ch].set(False),
        )

    def set_secondary(self, state: FastState, ch: int, code: str,
                      phase: int, pure_pilot: bool = True) -> FastState:
        """Enable secondary-code wipe-off for a channel: ``code`` is the
        "0"/"1" secondary sequence (NH20, CS100, ...), ``phase`` the
        secondary index of the channel's NEXT period.

        ``pure_pilot=True`` (a dataless pilot component drives the loops)
        also switches the PLL to the four-quadrant discriminator
        (d_cloop=false in run_dll_pll, dll_pll_veml_tracking.cc:1110);
        ``False`` keeps Costas for data-carrying channels whose secondary
        rides ON the data (BeiDou B1I/B3I NH20 — groups must then be
        bit-aligned so the data sign is constant inside a group)."""
        signs = np.asarray([1.0 if c in "0+" else -1.0 for c in code],
                           dtype=np.float32)
        if signs.shape[0] > self.sec_max_len:
            raise ValueError(
                f"secondary length {signs.shape[0]} > engine sec_max_len "
                f"{self.sec_max_len}")
        padded = np.ones((self.sec_max_len,), dtype=np.float32)
        padded[:signs.shape[0]] = signs
        return state._replace(
            sec_signs=state.sec_signs.at[ch].set(jnp.asarray(padded)),
            sec_len=state.sec_len.at[ch].set(int(signs.shape[0])),
            sec_phase=state.sec_phase.at[ch].set(
                int(phase) % signs.shape[0]),
            secondary_locked=state.secondary_locked.at[ch].set(
                bool(pure_pilot)),
        )

    # -- code bank (bank correlator) ----------------------------------------

    def _get_bank(self, code_tables) -> jax.Array:
        """[C, P+1, T, win_len] resampled-code bank.

        Row p holds each tap's code replica resampled at the nominal code
        rate with a sub-sample start phase p/P; per period the engine
        selects the two rows bracketing the exact remnant code phase and
        interpolates linearly. This replaces the per-chip prefix-sum
        gather with one dense contraction over contiguous sample
        windows."""
        # identity cache: hold a strong reference to the key array so its
        # id() cannot be recycled by the allocator while the entry lives
        if self._bank_cache is not None and self._bank_cache[0] is code_tables:
            return self._bank_cache[1]
        out = jnp.asarray(self._build_bank(
            code_tables, np.asarray(self._shifts, dtype=np.float64)))
        self._bank_cache = (code_tables, out)
        return out

    def _get_data_bank(self, data_code_tables) -> jax.Array:
        """[C, P+1, 1, win_len] single-prompt bank for the data-component
        code (d_correlator_data role, dll_pll_veml_tracking.cc:1064-1090):
        same NCO trajectory as the pilot, one tap at zero shift."""
        if self._data_bank_cache is not None \
                and self._data_bank_cache[0] is data_code_tables:
            return self._data_bank_cache[1]
        out = jnp.asarray(self._build_bank(
            data_code_tables, np.zeros((1,), dtype=np.float64)))
        self._data_bank_cache = (data_code_tables, out)
        return out

    def _build_bank(self, code_tables, shifts: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        tables = np.asarray(code_tables, dtype=np.float32)
        c, table_len = tables.shape
        p_phases = self.BANK_PHASES
        n_taps = shifts.shape[0]
        # nominal code period in samples (exact fs/chip-rate ratio)
        t_nom = cfg.code_length_chips / (cfg.chip_rate_cps / cfg.fs)
        code_step_table = (cfg.chip_rate_cps / cfg.fs
                           * cfg.code_samples_per_chip)
        ll = np.arange(self.win_len, dtype=np.float64)
        bank = np.zeros((c, p_phases + 1, n_taps, self.win_len),
                        dtype=np.float32)
        for p in range(p_phases + 1):
            q = p / p_phases
            support = ll < (round(t_nom) + (1 if q > 0 else 0))
            for t in range(n_taps):
                idx = np.floor((ll - q) * code_step_table
                               + shifts[t]).astype(np.int64) % table_len
                rows = tables[:, idx] * support[None, :].astype(np.float32)
                bank[:, p, t, :] = rows
        return bank

    # -- device program ----------------------------------------------------
    def _build(self):
        cfg = self.cfg
        k_ext = self.k
        fs = jnp.float32(cfg.fs)
        chip_rate = jnp.float32(cfg.chip_rate_cps)
        code_len_chips = jnp.float32(cfg.code_length_chips)
        cspc = jnp.float32(cfg.code_samples_per_chip)
        carrier_hz = jnp.float32(cfg.carrier_hz)
        t_group = jnp.float32(cfg.code_period_s * k_ext)
        shifts = self._shifts
        gains = self._gains
        dll_ic, dll_oc = self._dll_ic, self._dll_oc
        L = self.max_period
        Lg = self.k * cfg.samples_per_code + 64
        block_samples = self.block_samples
        total = block_samples + self.overlap
        n_taps = self.n_taps
        prompt_tap = n_taps // 2
        code_table_len = cfg.code_length_chips * cfg.code_samples_per_chip
        tiny = jnp.finfo(jnp.float32).tiny
        # nominal period length split into exact-int + small-fraction parts
        # (see FastState.code_doppler_chips precision note): boundary sums
        # at ~2.5e5 samples have a 0.0156-sample f32 ULP, ~2 m of
        # pseudorange quantization fed straight into the DLL
        t_nom_f64 = cfg.code_length_chips * cfg.fs / cfg.chip_rate_cps
        t_int = jnp.int32(math.floor(t_nom_f64))
        t_frac_nom = jnp.float32(t_nom_f64 - math.floor(t_nom_f64))
        t_nom_over_f0 = jnp.float32(t_nom_f64 / cfg.chip_rate_cps)
        code_step_nom = jnp.float32(
            cfg.chip_rate_cps / cfg.fs * cfg.code_samples_per_chip)
        half_t_over_f0 = jnp.float32(0.5 * t_nom_f64 / cfg.chip_rate_cps)

        def close_loops(s, process, t_frac, starts, rems,
                        corr_re, corr_im, data_re=None, data_im=None):
            """Shared post-correlation path: group accumulation,
            DLL/PLL closure, carry, C/N0/locks, outputs. ``t_frac`` is the
            per-channel fractional part of the period length (period =
            t_int + t_frac samples). ``data_re/im`` are per-period
            data-component prompts [C, K] (track_pilot), else None."""
            # NCO step includes the per-channel IF (FDMA slot); outputs
            # report Doppler-only phase increments
            step = jnp.float32(TWO_PI) * (s.carrier_doppler_hz
                                          + s.if_freq_hz) / fs         # [C]
            # pilot secondary-code wipe-off before coherent accumulation
            # (save_correlation_results, dll_pll_veml_tracking.cc:1290):
            # period j's sign is sec_signs[(sec_phase + j) % sec_len]
            if self.sec_max_len > 1:
                jj = jnp.arange(k_ext, dtype=jnp.int32)                # [K]
                sec_idx = jnp.mod(s.sec_phase[:, None] + jj[None, :],
                                  s.sec_len[:, None])                  # [C,K]
                signs = jnp.take_along_axis(s.sec_signs, sec_idx, axis=1)
                corr_re = corr_re * signs[:, :, None]
                corr_im = corr_im * signs[:, :, None]
                new_sec_phase = jnp.mod(s.sec_phase + k_ext, s.sec_len)
            else:
                new_sec_phase = s.sec_phase
            # group-coherent accumulation (bit-aligned)
            g_re = jnp.sum(corr_re, axis=1)                            # [C,T]
            g_im = jnp.sum(corr_im, axis=1)
            ep_re = g_re[:, prompt_tap]
            ep_im = g_im[:, prompt_tap]

            # ---- loop closure (extended-mode semantics) -----------------
            # secondary-locked pilots run the four-quadrant discriminator
            # (no Costas ambiguity once the secondary is wiped,
            # run_dll_pll d_cloop=false)
            pll_rad = jnp.where(
                s.secondary_locked,
                disc.pll_four_quadrant_atan(ep_re, ep_im),
                disc.pll_cloop_two_quadrant_atan(ep_re, ep_im))
            pll_hz = pll_rad / TWO_PI
            if cfg.veml:
                dll_d = disc.dll_nc_vemlp_normalized(
                    g_re[:, 0], g_im[:, 0], g_re[:, 1], g_im[:, 1],
                    g_re[:, 3], g_im[:, 3], g_re[:, 4], g_im[:, 4])
            else:
                dll_d = disc.dll_nc_e_minus_l_normalized(
                    g_re[:, 0], g_im[:, 0], g_re[:, 2], g_im[:, 2],
                    cfg.spc, cfg.slope, cfg.y_intercept)
            if self.loop == "kf":
                # 4-state code/carrier KF closure (kf_tracking role):
                # the discriminators feed the measurement update; the
                # phase corrections are applied to the remnant carries
                # (error-state reset) and the rates come from the
                # Doppler(+rate) states with implicit carrier aiding.
                from gnss_sdr_tpu.ops.kalman import KfState, kf_step

                kf_new, delta = kf_step(
                    KfState(x=s.kf_x, p=s.kf_p), dll_d, pll_rad,
                    float(cfg.code_period_s * k_ext), self.kf_cfg)
                carrier_doppler = kf_new.x[:, 2]
                code_dop = carrier_doppler * (chip_rate / carrier_hz)
                kf_x, kf_p = kf_new.x, kf_new.p
                gs_niw = s.gs_niw
                code_corr_chips = delta[:, 0]
                carr_corr_rad = delta[:, 1]
                carr_w, carr_x = s.carr_w, s.carr_x
                code_x_hist, code_y_hist = s.code_x_hist, s.code_y_hist
            elif self.loop == "gaussian":
                # Gaussian carrier-KF closure (gps_l1_ca_gaussian_tracking
                # role): the atan phase discriminator feeds an order-2/3
                # carrier-phase Kalman filter with NIW-adaptive R; code
                # closes through the standard DLL filter as a phase
                # correction, with full carrier aiding of the code rate
                # (gps_l1_ca_gaussian_tracking_cc.cc:717-738).
                from gnss_sdr_tpu.ops.gaussian import (GaussState,
                                                       gaussian_step)

                gst = GaussState(
                    x=s.kf_x[:, 1:1 + self.gs_cfg.order],
                    p=s.kf_p[:, 1:1 + self.gs_cfg.order,
                             1:1 + self.gs_cfg.order],
                    niw_iter=s.gs_niw[:, 0].astype(jnp.int32),
                    niw_n=s.gs_niw[:, 1].astype(jnp.int32),
                    niw_mu=s.gs_niw[:, 2], niw_psi=s.gs_niw[:, 3])
                gnew, ginfo = gaussian_step(
                    gst, pll_rad, s.cn0_db_hz,
                    float(cfg.code_period_s * k_ext), self.gs_cfg)
                carrier_doppler = ginfo["carrier_doppler_hz"]
                code_dop = carrier_doppler * (chip_rate / carrier_hz)
                (code_x_hist, code_y_hist), code_err = lf.iir_step(
                    (s.code_x_hist, s.code_y_hist), dll_d, dll_ic, dll_oc)
                # filter output [chips/s] applied as a phase correction
                # over the group (K_blk_samples adjustment, :729-738)
                code_corr_chips = code_err * t_group
                carr_corr_rad = ginfo["phase_corr_rad"]
                kf_x = s.kf_x.at[:, 1:1 + self.gs_cfg.order].set(gnew.x)
                kf_p = s.kf_p.at[:, 1:1 + self.gs_cfg.order,
                                 1:1 + self.gs_cfg.order].set(gnew.p)
                gs_niw = jnp.stack(
                    [gnew.niw_iter.astype(jnp.float32),
                     gnew.niw_n.astype(jnp.float32),
                     gnew.niw_mu, gnew.niw_psi], axis=-1)
                carr_w, carr_x = s.carr_w, s.carr_x
            else:
                g_eff = types.SimpleNamespace(**dataclasses.asdict(gains))
                (carr_w, carr_x), carr_err = lf.fll_pll_step(
                    (s.carr_w, s.carr_x), jnp.zeros_like(pll_hz), pll_hz,
                    t_group, g_eff)
                carrier_doppler = carr_err
                (code_x_hist, code_y_hist), code_err = lf.iir_step(
                    (s.code_x_hist, s.code_y_hist), dll_d, dll_ic, dll_oc)
                code_dop = -code_err
                if cfg.carrier_aiding:
                    code_dop = code_dop \
                        + carrier_doppler * (chip_rate / carrier_hz)
                kf_x, kf_p = s.kf_x, s.kf_p
                gs_niw = s.gs_niw
                code_corr_chips = jnp.zeros_like(dll_d)
                carr_corr_rad = jnp.zeros_like(pll_rad)

            # ---- carry to next group ------------------------------------
            # int + small-fraction arithmetic: the integer part advances by
            # exactly K*t_int; only small floats are ever added, so no
            # precision is lost at large block offsets
            corr_samp = code_corr_chips * (fs / chip_rate)
            frac_end = s.rem_code_phase_samples \
                + jnp.float32(k_ext) * t_frac + corr_samp                # [C]
            fl_end = jnp.floor(frac_end)
            new_offset = s.offset + k_ext * t_int + fl_end.astype(jnp.int32)
            new_rem = frac_end - fl_end
            group_len = jnp.float32(k_ext * int(t_int)) \
                + jnp.float32(k_ext) * t_frac + corr_samp
            carr_incr = step * group_len + carr_corr_rad
            carr_incr_out = jnp.float32(TWO_PI) * s.carrier_doppler_hz \
                / fs * group_len + carr_corr_rad
            new_rem_carr = jnp.mod(s.rem_carr_phase_rad + carr_incr,
                                   jnp.float32(TWO_PI))

            # ---- C/N0 + locks (per group) -------------------------------
            pb_re = jnp.concatenate(
                [ep_re[:, None], s.prompt_buf_re[:, :-1]], axis=1)
            pb_im = jnp.concatenate(
                [ep_im[:, None], s.prompt_buf_im[:, :-1]], axis=1)
            count_pre = s.prompt_count
            have = count_pre >= cfg.cn0_samples
            first = count_pre == cfg.cn0_samples
            pcount = jnp.minimum(count_pre + 1, cfg.cn0_samples + 1)
            cn0_raw = lockdet.cn0_m2m4_estimator(pb_re, pb_im, t_group)
            a = jnp.float32(cfg.cn0_smoother_alpha)
            cn0_s = jnp.where(have, jnp.where(first, cn0_raw,
                              a * cn0_raw + (1 - a) * s.cn0_db_hz),
                              s.cn0_db_hz)
            lock_raw = lockdet.carrier_lock_detector(ep_re[:, None],
                                                     ep_im[:, None])
            al = jnp.float32(cfg.carrier_lock_test_smoother_alpha)
            lock_s = jnp.where(have, jnp.where(first, lock_raw,
                               al * lock_raw + (1 - al) * s.carrier_lock_test),
                               s.carrier_lock_test)
            cfail = jnp.where(have & (lock_s < cfg.carrier_lock_th),
                              s.carrier_lock_fail + 1,
                              jnp.maximum(s.carrier_lock_fail
                                          - have.astype(jnp.int32), 0))
            kfail = jnp.where(have & (cn0_s < cfg.cn0_min),
                              s.code_lock_fail + 1,
                              jnp.maximum(s.code_lock_fail
                                          - have.astype(jnp.int32), 0))
            loss = (cfail > cfg.max_carrier_lock_fail) \
                | (kfail > cfg.max_code_lock_fail)

            new = FastState(
                active=s.active, offset=new_offset,
                rem_code_phase_samples=new_rem,
                rem_carr_phase_rad=new_rem_carr,
                carrier_doppler_hz=carrier_doppler,
                if_freq_hz=s.if_freq_hz,
                code_doppler_chips=code_dop,
                carr_w=carr_w, carr_x=carr_x,
                code_x_hist=code_x_hist, code_y_hist=code_y_hist,
                p_old_re=ep_re, p_old_im=ep_im,
                prompt_buf_re=pb_re, prompt_buf_im=pb_im,
                prompt_count=pcount, cn0_db_hz=cn0_s,
                carrier_lock_test=lock_s,
                code_lock_fail=jnp.where(loss, 0, kfail),
                carrier_lock_fail=jnp.where(loss, 0, cfail),
                loss_of_lock=s.loss_of_lock | (loss & s.active),
                kf_x=kf_x, kf_p=kf_p, gs_niw=gs_niw,
                sec_signs=s.sec_signs, sec_len=s.sec_len,
                sec_phase=new_sec_phase,
                secondary_locked=s.secondary_locked,
            )

            def sel(a_new, a_old):
                mask = process
                extra = a_new.ndim - mask.ndim
                if extra:
                    mask = mask.reshape(mask.shape + (1,) * extra)
                return jnp.where(mask, a_new, a_old)

            merged = FastState(*(sel(nf, of) for nf, of in zip(new, s)))
            dopp_out = jnp.where(process, carrier_doppler,
                                 s.carrier_doppler_hz)
            cn0_out = jnp.where(process, cn0_s, s.cn0_db_hz)
            # data-component per-period prompts (the decoder's symbol
            # source on pilot-tracked bands); == pilot prompts otherwise
            dp_re = data_re if data_re is not None \
                else corr_re[:, :, prompt_tap]
            dp_im = data_im if data_im is not None \
                else corr_im[:, :, prompt_tap]
            outputs = dict(
                valid=process,
                group_start=s.offset,
                period_starts=starts,
                period_rems=rems,
                prompt_re=ep_re, prompt_im=ep_im,
                period_prompt_re=corr_re[:, :, prompt_tap],
                period_prompt_im=corr_im[:, :, prompt_tap],
                period_data_re=dp_re, period_data_im=dp_im,
                carrier_doppler_hz=dopp_out,
                code_freq_chips=chip_rate
                + jnp.where(process, code_dop, s.code_doppler_chips),
                carr_phase_incr_rad=jnp.where(process, carr_incr_out,
                                              0.0),
                cn0_db_hz=cn0_out,
                loss_of_lock=merged.loss_of_lock,
                # one flat per-group record [C, 5K+4] so the production
                # host path fetches a SINGLE device array per superblock
                # (each device->host read is a synchronizing round
                # trip): starts | rems | prompts | data_re |
                # data_im | dopp cn0 valid loss. Block-relative starts
                # stay < 2^24, exact in f32.
                packed=jnp.concatenate([
                    starts.astype(jnp.float32), rems,
                    corr_re[:, :, prompt_tap],
                    dp_re, dp_im,
                    dopp_out[:, None], cn0_out[:, None],
                    process.astype(jnp.float32)[:, None],
                    merged.loss_of_lock.astype(jnp.float32)[:, None],
                ], axis=1),
            )
            return merged, outputs

        def group_body(carry, _, block_re, block_im, code_tables,
                       data_code_tables=None):
            s: FastState = carry
            process = s.active & (s.offset < block_samples) \
                & (~s.loss_of_lock)

            # closed-form period boundaries for this group in exact-int +
            # small-fraction form: the integer part (offset + k*t_int) is
            # exact; only sub-sample fractions are ever summed in float32,
            # so boundaries keep full precision at any block offset.
            t_frac = t_frac_nom \
                - s.code_doppler_chips * t_nom_over_f0                 # [C]
            kk = jnp.arange(k_ext, dtype=jnp.float32)                  # [K]
            frac_k = s.rem_code_phase_samples[:, None] \
                + kk[None, :] * t_frac[:, None]                        # [C,K]
            fl_k = jnp.floor(frac_k)
            starts = s.offset[:, None] \
                + jnp.arange(k_ext, dtype=jnp.int32)[None, :] * t_int \
                + fl_k.astype(jnp.int32)                               # [C,K]
            rems = frac_k - fl_k                                       # [C,K]

            if self.correlator == "bank":
                # ---- code-bank correlation (default path) -------------
                # contiguous per-period window slices + one dense einsum
                # against the phase-quantized code bank, linearly
                # interpolated between the two bracketing phases. No
                # per-chip gathers.
                L_win = self.win_len
                win_start = jnp.clip(starts, 0, total - L_win)         # [C,K]
                win_re = jax.vmap(jax.vmap(
                    lambda st_: jax.lax.dynamic_slice(
                        block_re, (st_,), (L_win,))))(win_start)
                win_im = jax.vmap(jax.vmap(
                    lambda st_: jax.lax.dynamic_slice(
                        block_im, (st_,), (L_win,))))(win_start)
                n = jnp.arange(L_win, dtype=jnp.float32)
                step = jnp.float32(TWO_PI) * (s.carrier_doppler_hz
                                              + s.if_freq_hz) / fs     # [C]
                ph0 = s.rem_carr_phase_rad[:, None] + step[:, None] * (
                    win_start - s.offset[:, None]).astype(jnp.float32)
                phase = ph0[:, :, None] + step[:, None, None] * n[None, None]
                c_ = jnp.cos(phase)
                s_ = jnp.sin(phase)
                rot_re = win_re * c_ + win_im * s_                     # [C,K,L]
                rot_im = win_im * c_ - win_re * s_
                bank = code_tables                                     # [C,P+1,T,L]
                all_re = jnp.einsum("ckl,cptl->ckpt", rot_re, bank,
                                    precision=PRECISION)
                all_im = jnp.einsum("ckl,cptl->ckpt", rot_im, bank,
                                    precision=PRECISION)
                # mid-period code-Doppler drift correction: the bank rows
                # are resampled at the nominal chip rate, so a channel with
                # code Doppler d drifts d/f0 samples per sample against its
                # replica; shifting the start phase by -d*(t/2)/f0 centers
                # the residual on the period midpoint (zero-mean error).
                pf_eff = jnp.clip(
                    rems - (s.code_doppler_chips * half_t_over_f0)[:, None],
                    0.0, 1.0)
                pf = pf_eff * jnp.float32(self.BANK_PHASES)            # [C,K]
                j0 = jnp.clip(jnp.floor(pf).astype(jnp.int32), 0,
                              self.BANK_PHASES - 1)
                w = (pf - j0.astype(jnp.float32))[..., None]

                def _interp(x):
                    a0 = jnp.take_along_axis(
                        x, j0[:, :, None, None], axis=2)[:, :, 0]
                    a1 = jnp.take_along_axis(
                        x, (j0 + 1)[:, :, None, None], axis=2)[:, :, 0]
                    return (1.0 - w) * a0 + w * a1                     # [C,K,T]

                corr_re = _interp(all_re)
                corr_im = _interp(all_im)
                data_re = data_im = None
                if data_code_tables is not None:
                    # data-component prompt: same rotated windows, the
                    # data PRN code's single-tap bank
                    db = data_code_tables                  # [C,P+1,1,L]
                    d_all_re = jnp.einsum("ckl,cptl->ckpt", rot_re, db,
                                          precision=PRECISION)
                    d_all_im = jnp.einsum("ckl,cptl->ckpt", rot_im, db,
                                          precision=PRECISION)
                    data_re = _interp(d_all_re)[:, :, 0]   # [C,K]
                    data_im = _interp(d_all_im)[:, :, 0]
                return close_loops(s, process, t_frac, starts,
                                   rems, corr_re, corr_im,
                                   data_re, data_im)

            # ---- segmented-sum correlation ------------------------------
            # Avoids a per-sample code-table gather (3 taps x ~4
            # samples/chip random loads). Instead: rotate the
            # group's samples once, prefix-sum them, and read ONE prefix
            # value per chip boundary per tap — chip sums then contract
            # against the code table. Sample-to-chip assignment matches
            # the floor-resampler exactly; the only divergence from the
            # per-period gather form is that a tap's sub-chip spill at a
            # period boundary lands in the neighboring period's
            # correlator (noise-level, a few samples out of thousands).
            group_start = jnp.clip(s.offset, 0, total - Lg)            # [C]
            gw_re = jax.vmap(
                lambda b, o: jax.lax.dynamic_slice(b, (o,), (Lg,)),
                in_axes=(None, 0))(block_re, group_start)
            gw_im = jax.vmap(
                lambda b, o: jax.lax.dynamic_slice(b, (o,), (Lg,)),
                in_axes=(None, 0))(block_im, group_start)

            n = jnp.arange(Lg, dtype=jnp.float32)                      # [Lg]
            step = jnp.float32(TWO_PI) * (s.carrier_doppler_hz
                                          + s.if_freq_hz) / fs         # [C]
            phase = s.rem_carr_phase_rad[:, None] + step[:, None] * n[None, :]
            c_ = jnp.cos(phase)
            s_ = jnp.sin(phase)
            rot_re = gw_re * c_ + gw_im * s_
            rot_im = gw_im * c_ - gw_re * s_

            zeros1 = jnp.zeros((rot_re.shape[0], 1), dtype=jnp.float32)
            p_re = jnp.concatenate(
                [zeros1, jnp.cumsum(rot_re, axis=1)], axis=1)          # [C,Lg+1]
            p_im = jnp.concatenate(
                [zeros1, jnp.cumsum(rot_im, axis=1)], axis=1)

            # chip boundaries: global chip c of tap t starts at sample
            # ceil(r + (c - shift_t)/q) relative to the group start
            code_step = code_step_nom \
                + s.code_doppler_chips * (cspc / fs)                   # [C]
            n_chips = k_ext * code_table_len
            cc = jnp.arange(-1, n_chips + 2, dtype=jnp.float32)        # [Nb+1]
            r0 = s.rem_code_phase_samples                              # [C]
            a = jnp.ceil(
                r0[:, None, None]
                + (cc[None, None, :] - shifts[None, :, None])
                / code_step[:, None, None])                            # [C,T,Nb+1]
            a = jnp.clip(a, 0, Lg).astype(jnp.int32)

            pr = jnp.take_along_axis(p_re[:, None, :], a, axis=-1)
            pi_ = jnp.take_along_axis(p_im[:, None, :], a, axis=-1)
            seg_re = jnp.diff(pr, axis=-1)                             # [C,T,Nb]
            seg_im = jnp.diff(pi_, axis=-1)

            # fold the boundary spill bins into the edge periods' wrap
            # chips (the gather form's mod-wrap behavior)
            core_re = seg_re[..., 1:1 + n_chips]
            core_im = seg_im[..., 1:1 + n_chips]
            core_re = core_re.at[..., code_table_len - 1].add(
                seg_re[..., 0])
            core_im = core_im.at[..., code_table_len - 1].add(
                seg_im[..., 0])
            core_re = core_re.at[..., n_chips - code_table_len].add(
                seg_re[..., n_chips + 1])
            core_im = core_im.at[..., n_chips - code_table_len].add(
                seg_im[..., n_chips + 1])
            core_re = core_re.reshape(
                core_re.shape[0], n_taps, k_ext, code_table_len)
            core_im = core_im.reshape(
                core_im.shape[0], n_taps, k_ext, code_table_len)

            corr_re = jnp.einsum("ctkq,cq->ckt", core_re, code_tables,
                                 precision=PRECISION)
            corr_im = jnp.einsum("ctkq,cq->ckt", core_im, code_tables,
                                 precision=PRECISION)

            data_re = data_im = None
            if data_code_tables is not None:
                # data prompt from the prompt tap's chip sums against the
                # data PRN code (same NCO, zero shift)
                data_re = jnp.einsum("ckq,cq->ck",
                                     core_re[:, prompt_tap],
                                     data_code_tables, precision=PRECISION)
                data_im = jnp.einsum("ckq,cq->ck",
                                     core_im[:, prompt_tap],
                                     data_code_tables, precision=PRECISION)
            return close_loops(s, process, t_frac, starts, rems,
                               corr_re, corr_im, data_re, data_im)


        track_pilot = self.track_pilot

        def _block_run(state, block_re, block_im, code_tables,
                       data_code_tables):
            body = functools.partial(group_body, block_re=block_re,
                                     block_im=block_im,
                                     code_tables=code_tables,
                                     data_code_tables=data_code_tables)
            state, outputs = jax.lax.scan(
                lambda c, xs: body(c, xs), state, None, length=self.g)
            state = state._replace(
                offset=jnp.where(state.active,
                                 state.offset - block_samples, state.offset))
            return state, outputs

        if track_pilot:
            def block_step(state, block_re, block_im, code_tables,
                           data_code_tables):
                return _block_run(state, block_re, block_im, code_tables,
                                  data_code_tables)

            def superblock_step(state, blocks_re, blocks_im, code_tables,
                                data_code_tables):
                def outer(carry, blk):
                    return block_step(carry, blk[0], blk[1], code_tables,
                                      data_code_tables)

                return jax.lax.scan(outer, state, (blocks_re, blocks_im))

            def superblock_step_i8(state, blocks_i8, code_tables,
                                   data_code_tables):
                return superblock_step(state,
                                       blocks_i8[0].astype(jnp.float32),
                                       blocks_i8[1].astype(jnp.float32),
                                       code_tables, data_code_tables)

            def superblock_ring_i8(state, ring_i8, base, n_blocks,
                                   code_tables, data_code_tables):
                def outer(carry, b):
                    lo = base + b * block_samples
                    blk_re = jax.lax.dynamic_slice(
                        ring_i8[0], (lo,), (total,)).astype(jnp.float32)
                    blk_im = jax.lax.dynamic_slice(
                        ring_i8[1], (lo,), (total,)).astype(jnp.float32)
                    return block_step(carry, blk_re, blk_im, code_tables,
                                      data_code_tables)

                return jax.lax.scan(outer, state,
                                    jnp.arange(n_blocks, dtype=jnp.int32))
        else:
            def block_step(state, block_re, block_im, code_tables):
                return _block_run(state, block_re, block_im, code_tables,
                                  None)

            def superblock_step(state, blocks_re, blocks_im, code_tables):
                def outer(carry, blk):
                    return block_step(carry, blk[0], blk[1], code_tables)

                return jax.lax.scan(outer, state, (blocks_re, blocks_im))

            def superblock_step_i8(state, blocks_i8, code_tables):
                # int8 ingest: every loop quantity downstream of the
                # correlator is a normalized ratio (E-L envelopes, atan
                # discriminators, M2M4 C/N0, lock tests), so a common
                # input scale factor cancels — the device just widens to
                # f32. The re/im planes travel STACKED in one array
                # ([2, B, L]): one upload per superblock, not two.
                return superblock_step(state,
                                       blocks_i8[0].astype(jnp.float32),
                                       blocks_i8[1].astype(jnp.float32),
                                       code_tables)

            def superblock_ring_i8(state, ring_i8, base, n_blocks,
                                   code_tables):
                # Device-resident input: the capture (or staging ring)
                # lives on the device as planar int8 [2, L]; each block
                # slices itself from a traced base offset, so the
                # production receiver uploads the stream once instead of
                # once per call.
                def outer(carry, b):
                    lo = base + b * block_samples
                    blk_re = jax.lax.dynamic_slice(
                        ring_i8[0], (lo,), (total,)).astype(jnp.float32)
                    blk_im = jax.lax.dynamic_slice(
                        ring_i8[1], (lo,), (total,)).astype(jnp.float32)
                    return block_step(carry, blk_re, blk_im, code_tables)

                return jax.lax.scan(outer, state,
                                    jnp.arange(n_blocks, dtype=jnp.int32))

        self._superblock_step = jax.jit(superblock_step, donate_argnums=(0,))
        self._superblock_step_i8 = jax.jit(superblock_step_i8,
                                           donate_argnums=(0,))
        self._superblock_ring_i8 = jax.jit(
            superblock_ring_i8, donate_argnums=(0,), static_argnums=(3,))
        return block_step

    def process_block(self, state, block_re, block_im, code_tables,
                      data_code_tables=None):
        if self.correlator == "bank":
            code_tables = self._get_bank(code_tables)
            if data_code_tables is not None:
                data_code_tables = self._get_data_bank(data_code_tables)
        if self.track_pilot:
            if data_code_tables is None:
                raise ValueError("track_pilot engine needs data_code_tables")
            return self._block_step(state, block_re, block_im, code_tables,
                                    data_code_tables)
        return self._block_step(state, block_re, block_im, code_tables)
