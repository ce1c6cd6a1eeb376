"""Multi-channel DLL/PLL/FLL tracking engine.

Array-program redesign of the reference's universal tracking block
(/root/reference/src/algorithms/tracking/gnuradio_blocks/
dll_pll_veml_tracking.cc). The reference runs one GNU Radio thread per
channel, each consuming a dynamic number of samples per PRN period
(general_work, :1784-2152). Here:

- All channels advance in lockstep through a ``lax.scan`` over PRN periods
  within a fixed sample block; per-channel dynamic period lengths are
  handled with a static max length + valid-prefix masking, and the
  fractional remainder phase is carried exactly like the reference's
  remnant-phase scheme (update_tracking_vars, :1216-1288).
- Each scan step is the per-period pipeline: multicorrelator
  (do_correlation_step, :1064), discriminators + loop filters
  (run_dll_pll, :1092), NCO/length update (update_tracking_vars, :1216),
  C/N0 + lock watchdogs (cn0_and_tracking_lock_status, :970) including the
  fork's EVM indicator (:1030-1056).
- Channels whose next period starts beyond the block's main region idle
  (masked) and resume in the next overlapped block — replacing GNU Radio's
  ring-buffer backpressure with overlap-save block streaming.

Absolute sample/phase accounting (64-bit) stays on the host
(:class:`TrackingChannels` in channels.py); the device carries only
block-relative offsets and per-period increments in float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sdr_tpu.ops import discriminators as disc
from gnss_sdr_tpu.ops import lock_detectors as lockdet
from gnss_sdr_tpu.ops import loop_filters as lf
from gnss_sdr_tpu.ops.correlator import multicorrelate

TWO_PI = 2.0 * math.pi

#: jitted program sets keyed by (config, n_channels, block, unroll) —
#: shared across engine instances so fresh receivers skip re-tracing
_PROGRAM_CACHE: dict = {}


@dataclasses.dataclass
class TrackingConfig:
    """Tracking knobs + per-signal constants.

    Field-for-field analogue of ``Dll_Pll_Conf``
    (/root/reference/src/algorithms/tracking/libs/dll_pll_conf.h:40-83)
    plus the signal constants the reference engine pulls from its ctor.
    Defaults mirror the reference's (header initializers and gflags
    defaults, gnss_sdr_flags.cc:45-54).
    """

    fs: float = 2_000_000.0
    # signal constants
    code_length_chips: int = 1023
    chip_rate_cps: float = 1.023e6
    carrier_hz: float = 1575.42e6
    code_samples_per_chip: int = 1
    symbols_per_bit: int = 20
    # loop configuration
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    fll_bw_hz: float = 35.0
    pll_filter_order: int = 3
    dll_filter_order: int = 2
    enable_fll_pull_in: bool = False
    enable_fll_steady_state: bool = False
    pull_in_time_s: float = 10.0
    early_late_space_chips: float = 0.25
    very_early_late_space_chips: float = 0.5
    veml: bool = False
    slope: float = 1.0
    spc: float = 0.5
    y_intercept: float = 1.0
    carrier_aiding: bool = True
    extend_correlation_symbols: int = 1
    # dual-component (pilot + data) signals: loops close on the pilot code
    # (the main code_tables); an extra prompt correlator runs against the
    # data component's code (the reference's d_correlator_data /
    # track_pilot path, dll_pll_veml_tracking.cc:211-246 and :1064-1090)
    track_pilot: bool = False
    pll_bw_narrow_hz: float = 5.0
    dll_bw_narrow_hz: float = 0.75
    # lock detection
    cn0_samples: int = 20
    cn0_min: float = 25.0
    max_code_lock_fail: int = 50
    max_carrier_lock_fail: int = 5000
    carrier_lock_th: float = 0.7
    cn0_smoother_alpha: float = 0.002
    carrier_lock_test_smoother_alpha: float = 0.002

    @property
    def samples_per_code(self) -> int:
        return int(round(self.fs * self.code_length_chips / self.chip_rate_cps))

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_cps

    @property
    def n_taps(self) -> int:
        return 5 if self.veml else 3

    def tap_shifts(self) -> np.ndarray:
        """Correlator tap shifts in code-table units, VE..VL order
        (dll_pll_veml_tracking.cc ctor, d_local_code_shift_chips)."""
        spc = self.early_late_space_chips * self.code_samples_per_chip
        if self.veml:
            vspc = self.very_early_late_space_chips * self.code_samples_per_chip
            return np.array([-vspc, -spc, 0.0, spc, vspc], dtype=np.float32)
        return np.array([-spc, 0.0, spc], dtype=np.float32)


class TrackState(NamedTuple):
    """Per-channel tracking carry; every field has leading dim [C]."""

    active: jax.Array              # bool: channel assigned and tracking
    offset: jax.Array              # int32: block-relative next period start
    cur_len: jax.Array             # int32: current period length [samples]
    rem_code_phase_samples: jax.Array  # f32
    rem_code_phase_chips: jax.Array    # f32 (code-table units)
    rem_carr_phase_rad: jax.Array      # f32
    carrier_doppler_hz: jax.Array      # f32
    if_freq_hz: jax.Array          # f32: per-channel intermediate-frequency
    #   offset (GLONASS FDMA slot carrier k*562.5 kHz at L1,
    #   GLONASS_L1_L2_CA.h:76-79). Added to the carrier NCO on top of the
    #   loop's Doppler; excluded from the loop state, carrier aiding and
    #   the Doppler/phase outputs so observables stay geometry-referenced.
    code_doppler_chips: jax.Array      # f32: code freq MINUS nominal chip
    #   rate. Stored as an offset so float32 keeps sub-mHz resolution: at
    #   1.023e6 cps an absolute f32 code frequency has a 0.0625 cps LSB,
    #   which quantizes the code NCO rate and limit-cycles the DLL
    #   (meter-level pseudorange wander).
    carrier_phase_step_rad: jax.Array  # f32
    code_phase_step_chips: jax.Array   # f32 (code-table units per sample)
    carr_w: jax.Array              # f32: FLL/PLL filter state
    carr_x: jax.Array              # f32
    code_x_hist: jax.Array         # f32 [C, 4]
    code_y_hist: jax.Array         # f32 [C, 3]
    p_old_re: jax.Array            # f32: previous prompt (FLL memory)
    p_old_im: jax.Array
    prompt_buf_re: jax.Array       # f32 [C, cn0_samples], newest first
    prompt_buf_im: jax.Array
    prompt_count: jax.Array        # int32 (capped)
    cn0_db_hz: jax.Array           # f32 (smoothed)
    carrier_lock_test: jax.Array   # f32 (smoothed)
    evm: jax.Array                 # f32 (fork indicator)
    code_lock_fail: jax.Array      # int32
    carrier_lock_fail: jax.Array   # int32
    loss_of_lock: jax.Array        # bool
    step_count: jax.Array          # int32: periods since channel start
    extended: jax.Array            # bool: extended coherent integration on
    secondary_locked: jax.Array    # bool: secondary code wiped (pure PLL)
    secondary_signs: jax.Array     # f32 [C, K]: per-period sign wipe-off
    accu_count: jax.Array          # int32: periods accumulated so far
    accu_re: jax.Array             # f32 [C, T]: coherent accumulator
    accu_im: jax.Array             # f32 [C, T]


class TrackingEngine:
    """Builds and jit-compiles the per-block tracking program.

    ``block_samples`` is the stream advance per call; input blocks carry
    ``overlap`` extra trailing samples (>= max period length) so a period
    straddling the block edge is fully contained.
    """

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 block_samples: int, scan_unroll: int = 4):
        self.cfg = cfg
        self.n_channels = n_channels
        self.block_samples = int(block_samples)
        #: lax.scan unroll factor for the per-period loop: each scan
        #: iteration carries a fixed sequencing overhead on the device
        #: (small kernels + loop bookkeeping); unrolling lets XLA fuse across
        #: consecutive periods. Pure semantics no-op.
        self.scan_unroll = int(scan_unroll)
        spc = cfg.samples_per_code
        # margin absorbs Doppler-induced length changes (<< 16 samples) and
        # the +-1 rounding of K_blk_samples
        self.max_period = spc + 16
        self.overlap = self.max_period
        self.n_steps = self.block_samples // max(1, spc - 16) + 1

        self._shifts = jnp.asarray(cfg.tap_shifts())
        self._gains = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_hz, cfg.pll_filter_order
        )
        ic, oc = lf.loop_filter_coefficients(
            cfg.code_period_s, cfg.dll_bw_hz, cfg.dll_filter_order,
            include_last_integrator=False,
        )
        self._dll_ic = jnp.asarray(ic)
        self._dll_oc = jnp.asarray(oc)
        ic_n, oc_n = lf.loop_filter_coefficients(
            cfg.code_period_s * cfg.extend_correlation_symbols,
            cfg.dll_bw_narrow_hz, cfg.dll_filter_order,
            include_last_integrator=False,
        )
        self._dll_ic_narrow = jnp.asarray(ic_n)
        self._dll_oc_narrow = jnp.asarray(oc_n)
        self._gains_narrow = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_narrow_hz, cfg.pll_filter_order
        )
        # pull-in transitory is counted in (wide-mode) PRN periods
        self._pull_in_steps = int(cfg.pull_in_time_s / cfg.code_period_s)
        # Programs are cached ACROSS engine instances with equal configs:
        # every fresh receiver otherwise re-traces the whole block program
        # (seconds of host time at cold start even with a warm XLA
        # compile cache).
        key = (dataclasses.astuple(cfg), n_channels, self.block_samples,
               self.scan_unroll)
        progs = _PROGRAM_CACHE.get(key)
        if progs is None:
            single, multi, multi_i8, ring_i8 = self._build_block_step()
            progs = (
                jax.jit(single, donate_argnums=(0,)),
                # superblock: K blocks per device call (amortizes dispatch
                # latency; the steady-state path for real-time operation)
                jax.jit(multi, donate_argnums=(0,)),
                jax.jit(multi_i8, donate_argnums=(0,)),
                # ring form: the whole capture (or a staging ring) lives
                # on the device as planar int8 and each superblock slices
                # its blocks on-device from a traced base offset, so the
                # stream is uploaded once instead of once per call.
                jax.jit(ring_i8, donate_argnums=(0,), static_argnums=(3,)),
                jax.jit(self._start_channel_impl),
            )
            _PROGRAM_CACHE[key] = progs
        (self._block_step, self._superblock_step, self._superblock_step_i8,
         self._superblock_ring_i8, self._start_channel_jit) = progs

    # -- state construction ------------------------------------------------
    def init_state(self) -> TrackState:
        c = self.n_channels
        f32 = functools.partial(jnp.zeros, (c,), dtype=jnp.float32)
        i32 = functools.partial(jnp.zeros, (c,), dtype=jnp.int32)
        return TrackState(
            active=jnp.zeros((c,), dtype=bool),
            offset=i32(), cur_len=jnp.full((c,), self.cfg.samples_per_code,
                                           dtype=jnp.int32),
            rem_code_phase_samples=f32(), rem_code_phase_chips=f32(),
            rem_carr_phase_rad=f32(), carrier_doppler_hz=f32(),
            if_freq_hz=f32(),
            code_doppler_chips=f32(),
            carrier_phase_step_rad=f32(),
            code_phase_step_chips=jnp.full(
                (c,), self.cfg.chip_rate_cps / self.cfg.fs
                * self.cfg.code_samples_per_chip, dtype=jnp.float32),
            carr_w=f32(), carr_x=f32(),
            code_x_hist=jnp.zeros((c, lf.HISTORY), dtype=jnp.float32),
            code_y_hist=jnp.zeros((c, lf.HISTORY - 1), dtype=jnp.float32),
            p_old_re=f32(), p_old_im=f32(),
            prompt_buf_re=jnp.zeros((c, self.cfg.cn0_samples),
                                    dtype=jnp.float32),
            prompt_buf_im=jnp.zeros((c, self.cfg.cn0_samples),
                                    dtype=jnp.float32),
            prompt_count=i32(), cn0_db_hz=f32(), carrier_lock_test=f32(),
            evm=f32(), code_lock_fail=i32(), carrier_lock_fail=i32(),
            loss_of_lock=jnp.zeros((c,), dtype=bool), step_count=i32(),
            extended=jnp.zeros((c,), dtype=bool),
            secondary_locked=jnp.zeros((c,), dtype=bool),
            secondary_signs=jnp.ones(
                (c, max(1, self.cfg.extend_correlation_symbols)),
                dtype=jnp.float32),
            accu_count=i32(),
            accu_re=jnp.zeros((c, self.cfg.n_taps), dtype=jnp.float32),
            accu_im=jnp.zeros((c, self.cfg.n_taps), dtype=jnp.float32),
        )

    def start_channel(
        self, state: TrackState, ch: int, doppler_hz: float,
        offset_samples: int, cur_len: int, if_freq_hz: float = 0.0,
    ) -> TrackState:
        """Functional per-channel (re)start after acquisition handoff.

        Mirrors start_tracking + the state-1 pull-in initialization
        (dll_pll_veml_tracking.cc:1813-1844): Doppler from acquisition,
        nominal code frequency, zero remnant phases, loop filters
        initialized from the acquisition Doppler.

        The ~30-field update runs as ONE jitted program (ch is a traced
        index): issued eagerly it is ~30 tiny device dispatches, which at
        remote-accelerator round-trip latency costs seconds when a
        12-channel cold start assigns every channel at once.
        """
        return self._start_channel_jit(
            state, jnp.int32(ch), jnp.float32(doppler_hz),
            jnp.int32(offset_samples), jnp.int32(cur_len),
            jnp.float32(if_freq_hz))

    def _start_channel_impl(
        self, state: TrackState, ch, doppler, offset_samples, cur_len,
        if_freq_hz,
    ) -> TrackState:
        cfg = self.cfg
        doppler_hz = doppler
        if self._gains.order == 3:
            w0, x0 = jnp.float32(0.0), 2.0 * doppler
        else:
            w0, x0 = doppler, jnp.float32(0.0)
        cspc = cfg.code_samples_per_chip
        return state._replace(
            active=state.active.at[ch].set(True),
            offset=state.offset.at[ch].set(offset_samples),
            cur_len=state.cur_len.at[ch].set(cur_len),
            rem_code_phase_samples=state.rem_code_phase_samples.at[ch].set(0.0),
            rem_code_phase_chips=state.rem_code_phase_chips.at[ch].set(0.0),
            rem_carr_phase_rad=state.rem_carr_phase_rad.at[ch].set(0.0),
            carrier_doppler_hz=state.carrier_doppler_hz.at[ch].set(doppler),
            if_freq_hz=state.if_freq_hz.at[ch].set(if_freq_hz),
            code_doppler_chips=state.code_doppler_chips.at[ch].set(0.0),
            carrier_phase_step_rad=state.carrier_phase_step_rad.at[ch].set(
                TWO_PI * (doppler_hz + if_freq_hz) / cfg.fs),
            code_phase_step_chips=state.code_phase_step_chips.at[ch].set(
                cfg.chip_rate_cps / cfg.fs * cspc),
            carr_w=state.carr_w.at[ch].set(w0),
            carr_x=state.carr_x.at[ch].set(x0),
            code_x_hist=state.code_x_hist.at[ch].set(0.0),
            code_y_hist=state.code_y_hist.at[ch].set(0.0),
            p_old_re=state.p_old_re.at[ch].set(0.0),
            p_old_im=state.p_old_im.at[ch].set(0.0),
            prompt_buf_re=state.prompt_buf_re.at[ch].set(0.0),
            prompt_buf_im=state.prompt_buf_im.at[ch].set(0.0),
            prompt_count=state.prompt_count.at[ch].set(0),
            cn0_db_hz=state.cn0_db_hz.at[ch].set(0.0),
            carrier_lock_test=state.carrier_lock_test.at[ch].set(0.0),
            evm=state.evm.at[ch].set(0.0),
            code_lock_fail=state.code_lock_fail.at[ch].set(0),
            carrier_lock_fail=state.carrier_lock_fail.at[ch].set(0),
            loss_of_lock=state.loss_of_lock.at[ch].set(False),
            step_count=state.step_count.at[ch].set(0),
            extended=state.extended.at[ch].set(False),
            secondary_locked=state.secondary_locked.at[ch].set(False),
            secondary_signs=state.secondary_signs.at[ch].set(1.0),
            accu_count=state.accu_count.at[ch].set(0),
            accu_re=state.accu_re.at[ch].set(0.0),
            accu_im=state.accu_im.at[ch].set(0.0),
        )

    def stop_channel(self, state: TrackState, ch: int) -> TrackState:
        return state._replace(active=state.active.at[ch].set(False))

    def set_extended(self, state: TrackState, ch: int,
                     periods_into_group: int = 0,
                     secondary_code: str | None = None) -> TrackState:
        """Switch a channel into extended coherent integration (the
        reference's state-2 -> state-3 transition after bit/secondary
        sync, dll_pll_veml_tracking.cc:1845-2028). ``periods_into_group``
        aligns the K-period accumulation groups with bit boundaries: it is
        how many periods of the current bit have already elapsed.

        The carrier loop filter is reinitialized from the current Doppler
        (as the reference does when re-parameterizing the loops): carrying
        the wide loop's integrator state into the narrow-bandwidth loop
        injects a slow multi-second transient.

        ``secondary_code`` ("0"/"1" string of length K) enables pilot
        secondary-code wipe-off: each period's correlators are multiplied
        by the corresponding sign before coherent accumulation
        (save_correlation_results, dll_pll_veml_tracking.cc:1290), and the
        PLL switches from Costas to the four-quadrant discriminator
        (d_cloop=false in run_dll_pll)."""
        doppler = state.carrier_doppler_hz[ch]
        if self._gains_narrow.order == 3:
            w0 = jnp.float32(0.0)
            x0 = 2.0 * doppler
        else:
            w0 = doppler
            x0 = jnp.float32(0.0)
        state = state._replace(
            extended=state.extended.at[ch].set(True),
            accu_count=state.accu_count.at[ch].set(int(periods_into_group)),
            accu_re=state.accu_re.at[ch].set(0.0),
            accu_im=state.accu_im.at[ch].set(0.0),
            carr_w=state.carr_w.at[ch].set(w0),
            carr_x=state.carr_x.at[ch].set(x0),
        )
        if secondary_code is not None:
            signs = np.asarray(
                [1.0 if c in "0+" else -1.0 for c in secondary_code],
                dtype=np.float32)
            k = state.secondary_signs.shape[1]
            if signs.shape[0] != k:
                raise ValueError(
                    f"secondary code length {signs.shape[0]} != K={k}")
            state = state._replace(
                secondary_signs=state.secondary_signs.at[ch].set(
                    jnp.asarray(signs)),
                secondary_locked=state.secondary_locked.at[ch].set(True),
            )
        return state

    # -- device program ----------------------------------------------------
    def _build_block_step(self):
        cfg = self.cfg
        fs = jnp.float32(cfg.fs)
        chip_rate = jnp.float32(cfg.chip_rate_cps)
        code_len_chips = jnp.float32(cfg.code_length_chips)
        cspc = jnp.float32(cfg.code_samples_per_chip)
        carrier_hz = jnp.float32(cfg.carrier_hz)
        # one PRN period (wide mode); extended mode scales by k_ext at use
        t_nominal = jnp.float32(cfg.code_period_s)
        # nominal period length split into exact-int + small-fraction parts
        # (see TrackState.code_doppler_chips precision note)
        t_nom_f64 = cfg.code_length_chips * cfg.fs / cfg.chip_rate_cps
        t_int = jnp.int32(math.floor(t_nom_f64))
        t_frac_nom = jnp.float32(t_nom_f64 - math.floor(t_nom_f64))
        t_nom_over_f0 = jnp.float32(t_nom_f64 / cfg.chip_rate_cps)
        code_step_nom = jnp.float32(
            cfg.chip_rate_cps / cfg.fs * cfg.code_samples_per_chip)
        shifts = self._shifts
        gains = self._gains
        gains_n = self._gains_narrow
        dll_ic, dll_oc = self._dll_ic, self._dll_oc
        dll_ic_n, dll_oc_n = self._dll_ic_narrow, self._dll_oc_narrow
        k_ext = max(1, cfg.extend_correlation_symbols)
        block_samples = self.block_samples
        total = self.block_samples + self.overlap
        max_period = self.max_period
        n_steps = self.n_steps
        prompt_tap = cfg.n_taps // 2
        pull_in_steps = self._pull_in_steps
        tiny = jnp.finfo(jnp.float32).tiny

        track_pilot = cfg.track_pilot
        zero_shift = jnp.zeros((1,), dtype=jnp.float32)

        def scan_body(carry, _, block_re, block_im, code_tables,
                      data_code_tables=None):
            s: TrackState = carry
            process = s.active & (s.offset < block_samples) & (~s.loss_of_lock)

            start = jnp.clip(s.offset, 0, total - max_period)
            slice_fn = jax.vmap(
                lambda b, o: jax.lax.dynamic_slice(b, (o,), (max_period,)),
                in_axes=(None, 0))
            x_re = slice_fn(block_re, start)
            x_im = slice_fn(block_im, start)

            corr_re, corr_im = multicorrelate(
                x_re, x_im, code_tables, shifts,
                s.rem_code_phase_chips, s.code_phase_step_chips,
                s.rem_carr_phase_rad, s.carrier_phase_step_rad,
                s.cur_len,
            )  # [C, T] each
            p_re = corr_re[:, prompt_tap]
            p_im = corr_im[:, prompt_tap]
            if track_pilot:
                # data-component prompt (d_correlator_data_cpu role): same
                # carrier/code NCO trajectory, the data PRN code, one tap
                dp_re, dp_im = multicorrelate(
                    x_re, x_im, data_code_tables, zero_shift,
                    s.rem_code_phase_chips, s.code_phase_step_chips,
                    s.rem_carr_phase_rad, s.carrier_phase_step_rad,
                    s.cur_len,
                )
                data_p_re = dp_re[:, 0]
                data_p_im = dp_im[:, 0]
            else:
                data_p_re = p_re
                data_p_im = p_im

            # ---- extended coherent integration (states 3/4,
            #      dll_pll_veml_tracking.cc:1989-2028) ---------------------
            # accumulate correlators across K periods; run the loops every
            # period in wide mode, every K-th period in extended mode
            sign = jnp.take_along_axis(
                s.secondary_signs,
                jnp.clip(s.accu_count, 0,
                         s.secondary_signs.shape[1] - 1)[:, None],
                axis=1)[:, 0]
            accu_re = s.accu_re + sign[:, None] * corr_re
            accu_im = s.accu_im + sign[:, None] * corr_im
            accu_count = s.accu_count + 1
            run_loops = (~s.extended) | (accu_count >= k_ext)
            eff_re = jnp.where(s.extended[:, None], accu_re, corr_re)
            eff_im = jnp.where(s.extended[:, None], accu_im, corr_im)
            ep_re = eff_re[:, prompt_tap]
            ep_im = eff_im[:, prompt_tap]
            t_eff = jnp.where(s.extended, t_nominal * k_ext, t_nominal)

            # ---- run_dll_pll (dll_pll_veml_tracking.cc:1092-1213) -------
            pll_costas = disc.pll_cloop_two_quadrant_atan(ep_re, ep_im)
            pll_4q = disc.pll_four_quadrant_atan(ep_re, ep_im)
            pll_disc_hz = jnp.where(s.secondary_locked, pll_4q,
                                    pll_costas) / TWO_PI
            fll_disc_hz = disc.fll_diff_atan(
                s.p_old_re, s.p_old_im, ep_re, ep_im, 0.0, t_eff) / TWO_PI
            pull_in = s.step_count < pull_in_steps
            if cfg.enable_fll_pull_in or cfg.enable_fll_steady_state:
                use_fll = (pull_in & cfg.enable_fll_pull_in) \
                    | cfg.enable_fll_steady_state
                fll_eff = jnp.where(use_fll, fll_disc_hz, 0.0)
                # pure FLL during pull-in (PLL disabled)
                pll_eff = jnp.where(pull_in & cfg.enable_fll_pull_in,
                                    0.0, pll_disc_hz)
            else:
                fll_eff = jnp.zeros_like(fll_disc_hz)
                pll_eff = pll_disc_hz
            # wide vs narrow carrier loop gains selected per channel
            import types as _types
            g_eff = _types.SimpleNamespace(
                order=gains.order,
                pll_w0p=jnp.where(s.extended, gains_n.pll_w0p, gains.pll_w0p),
                pll_w0p2=jnp.where(s.extended, gains_n.pll_w0p2,
                                   gains.pll_w0p2),
                pll_w0p3=jnp.where(s.extended, gains_n.pll_w0p3,
                                   gains.pll_w0p3),
                pll_w0f=jnp.where(s.extended, gains_n.pll_w0f, gains.pll_w0f),
                pll_w0f2=jnp.where(s.extended, gains_n.pll_w0f2,
                                   gains.pll_w0f2),
                pll_a2=gains.pll_a2, pll_a3=gains.pll_a3, pll_b3=gains.pll_b3,
            )
            (carr_w_new, carr_x_new), carr_err_hz = lf.fll_pll_step(
                (s.carr_w, s.carr_x), fll_eff, pll_eff, t_eff, g_eff
            )
            carr_w = jnp.where(run_loops, carr_w_new, s.carr_w)
            carr_x = jnp.where(run_loops, carr_x_new, s.carr_x)
            carrier_doppler = jnp.where(run_loops, carr_err_hz,
                                        s.carrier_doppler_hz)

            if cfg.veml:
                dll_disc = disc.dll_nc_vemlp_normalized(
                    eff_re[:, 0], eff_im[:, 0], eff_re[:, 1], eff_im[:, 1],
                    eff_re[:, 3], eff_im[:, 3], eff_re[:, 4], eff_im[:, 4])
            else:
                dll_disc = disc.dll_nc_e_minus_l_normalized(
                    eff_re[:, 0], eff_im[:, 0], eff_re[:, 2], eff_im[:, 2],
                    cfg.spc, cfg.slope, cfg.y_intercept)
            ic_eff = jnp.where(s.extended[:, None], dll_ic_n, dll_ic)
            oc_eff = jnp.where(s.extended[:, None], dll_oc_n, dll_oc)
            (code_x_new, code_y_new), code_err_filt = lf.iir_step(
                (s.code_x_hist, s.code_y_hist), dll_disc, ic_eff, oc_eff
            )
            code_x_hist = jnp.where(run_loops[:, None], code_x_new,
                                    s.code_x_hist)
            code_y_hist = jnp.where(run_loops[:, None], code_y_new,
                                    s.code_y_hist)
            code_dop_new = -code_err_filt
            if cfg.carrier_aiding:
                code_dop_new = code_dop_new \
                    + carrier_doppler * (chip_rate / carrier_hz)
            code_dop = jnp.where(run_loops, code_dop_new,
                                 s.code_doppler_chips)
            # reset the accumulator after a loop update
            clear = run_loops & s.extended
            accu_re = jnp.where(clear[:, None], 0.0, accu_re)
            accu_im = jnp.where(clear[:, None], 0.0, accu_im)
            accu_count = jnp.where(run_loops, 0, accu_count)

            # ---- update_tracking_vars (:1216-1288) ----------------------
            # Period length in int + small-fraction form: t_prn at ~2500
            # samples has a 2.4e-4-sample float32 ULP, which systematically
            # biases the code NCO rate; t_int is exact and t_frac stays
            # well inside float32 resolution.
            t_frac = t_frac_nom - code_dop * t_nom_over_f0
            kfrac = t_frac + s.rem_code_phase_samples
            dlen = jnp.floor(kfrac)
            next_len = t_int + dlen.astype(jnp.int32)
            rem_code_samples = kfrac - dlen
            # the NCO runs at IF + Doppler; the phase-increment *output*
            # (observables' accumulated carrier phase) is Doppler-only so
            # the FDMA slot ramp never enters the carrier-phase observable
            carr_step = jnp.float32(TWO_PI) * (carrier_doppler
                                               + s.if_freq_hz) / fs
            carr_incr = carr_step * next_len.astype(jnp.float32)
            carr_incr_out = jnp.float32(TWO_PI) * carrier_doppler / fs \
                * next_len.astype(jnp.float32)
            rem_carr = jnp.mod(s.rem_carr_phase_rad + carr_incr,
                               jnp.float32(TWO_PI))
            code_step = code_step_nom + code_dop * (cspc / fs)
            rem_code_chips = (chip_rate + code_dop) * rem_code_samples \
                / fs * cspc

            # ---- cn0_and_tracking_lock_status (:970-1062) ---------------
            # the prompt buffer collects one entry per loop update (per
            # period in wide mode, per K periods in extended mode)
            prompt_buf_re = jnp.where(
                run_loops[:, None],
                jnp.concatenate([ep_re[:, None], s.prompt_buf_re[:, :-1]],
                                axis=1),
                s.prompt_buf_re)
            prompt_buf_im = jnp.where(
                run_loops[:, None],
                jnp.concatenate([ep_im[:, None], s.prompt_buf_im[:, :-1]],
                                axis=1),
                s.prompt_buf_im)
            count_pre = s.prompt_count
            have_cn0 = count_pre >= cfg.cn0_samples
            first_cn0 = count_pre == cfg.cn0_samples
            prompt_count = jnp.minimum(
                count_pre + run_loops.astype(jnp.int32), cfg.cn0_samples + 1)

            cn0_raw = lockdet.cn0_m2m4_estimator(
                prompt_buf_re, prompt_buf_im, t_eff)
            a = jnp.float32(cfg.cn0_smoother_alpha)
            cn0_s = jnp.where(
                have_cn0 & run_loops,
                jnp.where(first_cn0, cn0_raw,
                          a * cn0_raw + (1 - a) * s.cn0_db_hz),
                s.cn0_db_hz)
            lock_raw = lockdet.carrier_lock_detector(
                ep_re[:, None], ep_im[:, None])
            al = jnp.float32(cfg.carrier_lock_test_smoother_alpha)
            lock_s = jnp.where(
                have_cn0 & run_loops,
                jnp.where(first_cn0, lock_raw,
                          al * lock_raw + (1 - al) * s.carrier_lock_test),
                s.carrier_lock_test)

            count_locks = have_cn0 & (~pull_in) & run_loops
            carrier_fail = jnp.where(
                count_locks & (lock_s < cfg.carrier_lock_th),
                s.carrier_lock_fail + 1,
                jnp.maximum(s.carrier_lock_fail - count_locks.astype(jnp.int32), 0))
            code_fail = jnp.where(
                count_locks & (cn0_s < cfg.cn0_min),
                s.code_lock_fail + 1,
                jnp.maximum(s.code_lock_fail - count_locks.astype(jnp.int32), 0))
            loss = (carrier_fail > cfg.max_carrier_lock_fail) \
                | (code_fail > cfg.max_code_lock_fail)
            carrier_fail = jnp.where(loss, 0, carrier_fail)
            code_fail = jnp.where(loss, 0, code_fail)

            # fork EVM indicator (:1030-1056)
            d = jnp.sqrt(jnp.mean(prompt_buf_re**2, axis=1))
            d = jnp.maximum(d, tiny)
            evm_raw = jnp.sqrt(jnp.mean(
                (jnp.abs(prompt_buf_re / d[:, None]) - 1.0) ** 2
                + (prompt_buf_im / d[:, None]) ** 2, axis=1))
            evm = jnp.where(have_cn0, evm_raw, s.evm)

            # Stream advance pairs with the freshly computed length, exactly
            # like the reference (consume_each(d_current_prn_length_samples)
            # AFTER update_tracking_vars, dll_pll_veml_tracking.cc:2119):
            # offset + next_len and rem_next derive from the same K_blk, so
            # the code boundary (offset + rem) advances by exactly T_prn per
            # period. Advancing by the stale cur_len instead slips the
            # boundary (and the pseudorange anchor) by +-1 sample for one
            # period at every rem wraparound.
            new = TrackState(
                active=s.active,
                offset=s.offset + next_len,
                cur_len=next_len,
                rem_code_phase_samples=rem_code_samples,
                rem_code_phase_chips=rem_code_chips,
                rem_carr_phase_rad=rem_carr,
                carrier_doppler_hz=carrier_doppler,
                if_freq_hz=s.if_freq_hz,
                code_doppler_chips=code_dop,
                carrier_phase_step_rad=carr_step,
                code_phase_step_chips=code_step,
                carr_w=carr_w, carr_x=carr_x,
                code_x_hist=code_x_hist, code_y_hist=code_y_hist,
                p_old_re=jnp.where(run_loops, ep_re, s.p_old_re),
                p_old_im=jnp.where(run_loops, ep_im, s.p_old_im),
                prompt_buf_re=prompt_buf_re, prompt_buf_im=prompt_buf_im,
                prompt_count=prompt_count,
                cn0_db_hz=cn0_s, carrier_lock_test=lock_s, evm=evm,
                code_lock_fail=code_fail, carrier_lock_fail=carrier_fail,
                loss_of_lock=s.loss_of_lock | (loss & s.active),
                step_count=s.step_count + 1,
                extended=s.extended,
                secondary_locked=s.secondary_locked,
                secondary_signs=s.secondary_signs,
                accu_count=accu_count,
                accu_re=accu_re, accu_im=accu_im,
            )

            def sel(a_new, a_old):
                mask = process
                extra = a_new.ndim - mask.ndim
                if extra:
                    mask = mask.reshape(mask.shape + (1,) * extra)
                return jnp.where(mask, a_new, a_old)

            merged = TrackState(*(sel(n_f, o_f) for n_f, o_f in zip(new, s)))

            dopp_out = jnp.where(process, carrier_doppler,
                                 s.carrier_doppler_hz)
            code_dop_out = jnp.where(process, code_dop,
                                     s.code_doppler_chips)
            carr_incr_out_m = jnp.where(process, carr_incr_out, 0.0)
            cn0_out = jnp.where(process, cn0_s, s.cn0_db_hz)
            lock_out = jnp.where(process, lock_s, s.carrier_lock_test)
            evm_out = jnp.where(process, evm, s.evm)
            outputs = dict(
                valid=process,
                start_offset=s.offset,
                length=s.cur_len,
                corr_re=corr_re,
                corr_im=corr_im,
                prompt_re=p_re,
                prompt_im=p_im,
                data_prompt_re=data_p_re,
                data_prompt_im=data_p_im,
                carrier_doppler_hz=dopp_out,
                code_freq_chips=chip_rate + code_dop_out,
                rem_code_phase_samples=s.rem_code_phase_samples,
                carr_phase_incr_rad=carr_incr_out_m,
                cn0_db_hz=cn0_out,
                carrier_lock_test=lock_out,
                evm=evm_out,
                loss_of_lock=merged.loss_of_lock,
                # one flat per-period record so the host fetches a SINGLE
                # device array per block (every np.asarray is a
                # synchronizing round trip). Layout (channels._emit):
                # [valid, start, length, rem, p_re, p_im, dp_re, dp_im,
                #  dopp, code_dop, carr_incr, cn0, lock, evm, loss,
                #  corr_re(T), corr_im(T)]. start < 2^24 is exact in f32;
                # code Doppler travels as the offset from the nominal
                # chip rate to keep sub-mHz resolution.
                packed=jnp.concatenate([
                    process.astype(jnp.float32)[:, None],
                    s.offset.astype(jnp.float32)[:, None],
                    s.cur_len.astype(jnp.float32)[:, None],
                    s.rem_code_phase_samples[:, None],
                    p_re[:, None], p_im[:, None],
                    data_p_re[:, None], data_p_im[:, None],
                    dopp_out[:, None], code_dop_out[:, None],
                    carr_incr_out_m[:, None], cn0_out[:, None],
                    lock_out[:, None], evm_out[:, None],
                    merged.loss_of_lock.astype(jnp.float32)[:, None],
                    corr_re, corr_im,
                ], axis=1),
            )
            return merged, outputs

        def _run(state: TrackState, block_re, block_im, code_tables,
                 data_code_tables):
            body = functools.partial(
                scan_body, block_re=block_re, block_im=block_im,
                code_tables=code_tables, data_code_tables=data_code_tables)
            state, outputs = jax.lax.scan(
                lambda c, xs: body(c, xs), state, None, length=n_steps,
                unroll=min(self.scan_unroll, n_steps))
            # rebase offsets for the next block (stream advances by
            # block_samples; the overlap region repeats)
            state = state._replace(
                offset=jnp.where(state.active,
                                 state.offset - block_samples, state.offset))
            return state, outputs

        if track_pilot:
            def block_step(state, block_re, block_im, code_tables,
                           data_code_tables):
                return _run(state, block_re, block_im, code_tables,
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
                return _run(state, block_re, block_im, code_tables, None)

            def superblock_step(state, blocks_re, blocks_im, code_tables):
                """K consecutive blocks in one program: outer scan over
                blocks, inner scan over PRN periods. blocks_* have shape
                [K, block_samples + overlap]."""

                def outer(carry, blk):
                    return block_step(carry, blk[0], blk[1], code_tables)

                return jax.lax.scan(outer, state, (blocks_re, blocks_im))

            def superblock_step_i8(state, blocks_i8, code_tables):
                # int8 ingest (see FastTrackingEngine): all loop
                # observables are normalized ratios, so the input scale
                # cancels and the device just widens to f32; re/im planes
                # ride one stacked upload ([2, B, L])
                return superblock_step(state,
                                       blocks_i8[0].astype(jnp.float32),
                                       blocks_i8[1].astype(jnp.float32),
                                       code_tables)

            def superblock_ring_i8(state, ring_i8, base, n_blocks,
                                   code_tables):
                """Same as superblock_step_i8 but the input is a
                device-resident planar-int8 ring ([2, L]); block b covers
                ring[:, base + b*block_samples :][:block+overlap]."""
                def outer(carry, b):
                    lo = base + b * block_samples
                    blk_re = jax.lax.dynamic_slice(
                        ring_i8[0], (lo,), (total,)).astype(jnp.float32)
                    blk_im = jax.lax.dynamic_slice(
                        ring_i8[1], (lo,), (total,)).astype(jnp.float32)
                    return block_step(carry, blk_re, blk_im, code_tables)

                return jax.lax.scan(outer, state,
                                    jnp.arange(n_blocks, dtype=jnp.int32))

        return block_step, superblock_step, superblock_step_i8, \
            superblock_ring_i8

    def process_block(
        self, state: TrackState, block_re: jax.Array, block_im: jax.Array,
        code_tables: jax.Array, data_code_tables: jax.Array | None = None,
    ):
        """Run one block; returns (new_state, outputs dict of [S, C] arrays).

        ``block_re``/``block_im`` are the planar complex IF samples,
        ``block_samples + overlap`` long. With ``cfg.track_pilot``,
        ``data_code_tables`` carries the data-component codes."""
        if block_re.shape[0] != self.block_samples + self.overlap:
            raise ValueError(
                f"block must have {self.block_samples + self.overlap} samples "
                f"(block_samples + overlap), got {block_re.shape[0]}"
            )
        if self.cfg.track_pilot:
            if data_code_tables is None:
                raise ValueError("track_pilot needs data_code_tables")
            return self._block_step(state, block_re, block_im, code_tables,
                                    data_code_tables)
        return self._block_step(state, block_re, block_im, code_tables)
