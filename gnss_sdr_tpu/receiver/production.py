"""Production receiver: pull in on the scan engine, cruise on the fast one.

The deployment topology for real-time serving (README "performance"):

- Phase A (cold start / transients): the per-period scan engine — exact
  reference semantics for acquisition handoff, FLL/PLL pull-in and
  bit synchronization.
- Handoff: when every tracking channel is bit-synced and past pull-in,
  each channel's stream position is advanced to its next data-bit
  boundary (<= 19 PRN periods) and the state is adopted by the
  group-batched fast engine.
- Phase B (steady state): 20 ms coherent groups, loops at 50 Hz, the
  group-batched correlator of tracking/fast_engine.py.

Telemetry, observables and PVT run identically in both phases (the fast
engine still emits per-period prompts and code-boundary anchors).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from gnss_sdr_tpu.pvt.solver import Observation
from gnss_sdr_tpu.pvt import GpsEphemeris, solve_pvt
from gnss_sdr_tpu.receiver.fsm import ChannelState
from gnss_sdr_tpu.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine

TWO_PI = 2.0 * math.pi


def quantize_i8(samples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Planar int8 (re, im) of a complex capture at 16 LSB per unit RMS,
    the scale estimated from its first 2^20 samples: the device ingest
    ring's format (the loops only see scale-free ratios)."""
    from gnss_sdr_tpu.native import complex_to_quantized_i8

    head = np.ascontiguousarray(samples[:1 << 20].real, np.float32)
    rms = float(np.sqrt(np.mean(head * head))) * np.sqrt(2.0) or 1.0
    return complex_to_quantized_i8(samples, 16.0 / rms)


class ProductionReceiver:
    def __init__(self, cfg: ReceiverConfig, satellites, assisted_ephemeris=None,
                 groups_per_block: int = 5, blocks_per_call: int = 10):
        if cfg.extend_correlation_symbols <= 1:
            raise ValueError(
                "ProductionReceiver needs extend_correlation_symbols > 1")
        self.cfg = cfg
        self.receiver = Receiver(cfg, satellites, assisted_ephemeris)
        self.groups_per_block = groups_per_block
        #: fast blocks per device call in steady state (dispatch latency
        #: amortization; 10 blocks = 1 simulated second at the defaults)
        self.blocks_per_call = blocks_per_call
        self.fast: FastTrackingEngine | None = None
        self.fast_state = None
        self._fast_codes = None
        self._cap8: tuple[np.ndarray, np.ndarray] | None = None
        self._ring = None  # device-resident [2, L] int8 capture
        self.handoff_sample: int | None = None
        self.solutions = self.receiver.solutions

    # -- phase A ----------------------------------------------------------
    def _channel_ready(self, ch: int) -> bool:
        rec = self.receiver
        return (rec._bit_sync[ch].synced
                and rec._period_count[ch]
                >= rec.cfg.pull_in_time_s * 1000 + 100)

    def _ready_for_handoff(self) -> bool:
        """All tracking channels past pull-in and bit-synced — or, after a
        grace period, a quorum of them (one sick channel must not pin the
        receiver on the latency-bound scan engine forever; the reference
        equivalent is a channel loss-of-lock event returning the SV to the
        pool, gnss_flowgraph.cc:1956-1996)."""
        rec = self.receiver
        tracking = [f for f in rec.fsms if f.state is ChannelState.TRACKING]
        if len(tracking) < min(4, rec.cfg.n_channels):
            return False
        ready = [f for f in tracking if self._channel_ready(f.channel_id)]
        if len(ready) == len(tracking):
            return True
        grace = rec.cfg.pull_in_time_s * 1000 + 100 + 1500
        if len(ready) >= min(4, rec.cfg.n_channels) and any(
                rec._period_count[f.channel_id] > grace for f in ready):
            # drop the stragglers back to the pool and hand off the quorum
            for f in tracking:
                if not self._channel_ready(f.channel_id):
                    ch = f.channel_id
                    prn = f.loss_of_lock()
                    if prn:
                        rec.sat_pool.append(prn)
                    rec.tracking.stop_channel(ch)
                    rec.observables.reset_channel(ch)
            return True
        return False

    def _handoff(self) -> None:
        rec = self.receiver
        trk_cfg = rec.tracking.cfg
        self.fast = FastTrackingEngine(
            trk_cfg, rec.cfg.n_channels, self.groups_per_block)
        state = self.fast.from_track_state(rec.tracking.state)
        # align every channel's next group to its data-bit boundary
        k = trk_cfg.extend_correlation_symbols
        offs = np.asarray(state.offset).copy()
        rems = np.asarray(state.rem_code_phase_samples).copy()
        rcarr = np.asarray(state.rem_carr_phase_rad).copy()
        steps = TWO_PI * np.asarray(state.carrier_doppler_hz) / trk_cfg.fs
        code_freq = trk_cfg.chip_rate_cps \
            + np.asarray(state.code_doppler_chips, dtype=np.float64)
        for f in rec.fsms:
            ch = f.channel_id
            if f.state is not ChannelState.TRACKING:
                continue
            into = rec._bit_sync[ch].periods_into_bit(rec._period_count[ch])
            skip = (k - into) % k
            t_prn = trk_cfg.fs * trk_cfg.code_length_chips / code_freq[ch]
            old_boundary = offs[ch] + rems[ch]
            boundary = old_boundary + skip * t_prn
            offs[ch] = math.floor(boundary)
            rems[ch] = boundary - offs[ch]
            rcarr[ch] = math.fmod(
                rcarr[ch] + steps[ch] * (boundary - old_boundary), TWO_PI)
            # The skipped periods are real transmitted symbols: leaving a
            # gap in the decoder's symbol stream breaks the 6000-symbol
            # preamble periodicity, subframe parity windows and per-symbol
            # TOW propagation (gps_l1_ca_telemetry_decoder_gs.cc counts
            # every symbol). They all belong to the current data bit, so
            # feed placeholders with the current bit's sign.
            dec = rec.decoders[ch]
            if skip and dec.history:
                last = dec.history[-1]
                stamp = dec.stamps[-1] if dec.stamps else 0
                for j in range(1, skip + 1):
                    dec.feed(last, stamp + int(round(j * t_prn)))
                rec._period_count[ch] += skip
        self.fast_state = state._replace(
            offset=jnp.asarray(offs.astype(np.int32)),
            rem_code_phase_samples=jnp.asarray(rems.astype(np.float32)),
            rem_carr_phase_rad=jnp.asarray(rcarr.astype(np.float32)),
        )
        self._fast_codes = rec.tracking._code_tables_dev
        self.handoff_sample = rec.tracking.abs_block_start

    # -- phase B ----------------------------------------------------------
    def _dispatch_ring(self, base: int, n_blocks: int):
        """Launch ``n_blocks`` consecutive fast blocks as ONE device call
        reading from the device-resident int8 ring, and return the
        (async) output handles. JAX dispatch is asynchronous: the host
        returns as soon as the program is enqueued, so the caller can
        consume the PREVIOUS superblock's outputs while the device runs
        this one."""
        fast = self.fast
        codes = fast._get_bank(self._fast_codes) \
            if fast.correlator == "bank" else self._fast_codes
        self.fast_state, out = fast._superblock_ring_i8(
            self.fast_state, self._ring, jnp.int32(base), int(n_blocks),
            codes)
        return out

    def _consume_superblock(self, out, base: int, n_blocks: int) -> None:
        """Host pass over one superblock's packed record: vectorized
        decoder feed (GpsLnavDecoder.feed_array) + bulk observables
        anchors instead of ~1000 Python calls per channel-second."""
        rec = self.receiver
        fast = self.fast
        fb = fast.block_samples
        # ONE device->host transfer: every per-group quantity the host
        # needs travels in the packed record (each read is a
        # synchronizing round trip)
        packed = np.asarray(out["packed"])
        bb, gg, n_ch, _ = packed.shape
        kk = fast.k
        t_prn_s = rec.tracking.cfg.code_period_s
        # per-(block,group) absolute base offsets
        block_base = base + np.arange(bb, dtype=np.int64)[:, None] * fb
        # layout (fast_engine close_loops ``packed``): starts | rems |
        # pilot prompts | data_re | data_im | dopp cn0 valid loss
        p2 = packed.reshape(bb * gg, n_ch, 5 * kk + 4)
        valid = p2[:, :, 5 * kk + 2] > 0.5
        dopp = p2[:, :, 5 * kk]
        cn0 = p2[:, :, 5 * kk + 1]
        starts = (np.repeat(block_base.reshape(-1), gg)[:, None, None]
                  + p2[:, :, :kk].astype(np.int64))
        rems = p2[:, :, kk:2 * kk]
        prompts = p2[:, :, 3 * kk:4 * kk]   # data-component (== pilot
        #                                     prompt on data-only bands)
        loss_any = (p2[:, :, 5 * kk + 3] > 0.5).any(axis=0)

        for f in rec.fsms:
            ch = f.channel_id
            if f.state is not ChannelState.TRACKING:
                continue
            rows = np.nonzero(valid[:, ch])[0]
            if rows.size:
                ch_starts = starts[rows, ch, :].reshape(-1)
                ch_rems = rems[rows, ch, :].reshape(-1)
                ch_prompts = prompts[rows, ch, :].reshape(-1)
                ch_dopp = np.repeat(dopp[rows, ch], kk)
                ch_cn0 = np.repeat(cn0[rows, ch], kk)
                tows = rec.decoders[ch].feed_array(ch_prompts, ch_starts)
                rec._period_count[ch] += ch_starts.size
                # accumulated carrier phase (64-bit, host): acc -= 2*pi*f*T
                acc0 = rec.tracking.acc_carrier_phase_rad[ch]
                acc = acc0 - TWO_PI * t_prn_s * np.cumsum(ch_dopp)
                rec.tracking.acc_carrier_phase_rad[ch] = acc[-1]
                known = ~np.isnan(tows)
                if known.any():
                    rec.observables.add_anchors(
                        ch, ch_starts[known] + ch_rems[known],
                        tows[known] - 1.0, ch_dopp[known], acc[known],
                        ch_cn0[known])
            dec = rec.decoders[ch]
            if dec.has_full_ephemeris() and f.prn not in rec.ephemerides:
                rec.ephemerides[f.prn] = GpsEphemeris.from_fields(
                    f.prn, dec.ephemeris_fields)
            if rec.iono is None \
                    and any(dec.utc_iono_fields.get("iono_alpha", ())):
                rec.iono = (dec.utc_iono_fields["iono_alpha"],
                            dec.utc_iono_fields["iono_beta"])
            if loss_any[ch]:
                f.loss_of_lock()
                rec.observables.reset_channel(ch)

    def _fast_block(self, samples: np.ndarray, base: int) -> None:
        """``samples`` is the full capture (absolute origin 0); ``base``
        the absolute sample index of this fast block."""
        rec = self.receiver
        fast = self.fast
        seg = samples[base: base + fast.block_samples + fast.overlap]
        re = jnp.asarray(np.ascontiguousarray(seg.real, np.float32))
        im = jnp.asarray(np.ascontiguousarray(seg.imag, np.float32))
        self.fast_state, out = fast.process_block(
            self.fast_state, re, im, self._fast_codes)
        out = {k: np.asarray(v) for k, v in out.items()}
        g_count, n_ch, kk = out["period_prompt_re"].shape
        for g in range(g_count):
            for f in rec.fsms:
                ch = f.channel_id
                if f.state is not ChannelState.TRACKING \
                        or not out["valid"][g, ch]:
                    continue
                dec = rec.decoders[ch]
                dopp = float(out["carrier_doppler_hz"][g, ch])
                cn0 = float(out["cn0_db_hz"][g, ch])
                t_prn_s = rec.tracking.cfg.code_period_s
                for j in range(kk):
                    start = base + int(out["period_starts"][g, ch, j])
                    rem = float(out["period_rems"][g, ch, j])
                    prompt_i = float(out["period_prompt_re"][g, ch, j])
                    dec.feed(prompt_i, start)
                    rec._period_count[ch] += 1
                    # accumulated carrier phase (64-bit, host), same
                    # convention as the scan path: acc -= 2*pi*f_d*T
                    rec.tracking.acc_carrier_phase_rad[ch] -= \
                        TWO_PI * dopp * t_prn_s
                    if dec.tow_at_last_symbol_ms is not None:
                        rec.observables.add_anchor(
                            ch, start + rem,
                            dec.tow_at_last_symbol_ms - 1.0,
                            dopp,
                            float(rec.tracking.acc_carrier_phase_rad[ch]),
                            cn0)
                if dec.has_full_ephemeris() and f.prn not in rec.ephemerides:
                    rec.ephemerides[f.prn] = GpsEphemeris.from_fields(
                        f.prn, dec.ephemeris_fields)
                if rec.iono is None \
                        and any(dec.utc_iono_fields.get("iono_alpha", ())):
                    rec.iono = (dec.utc_iono_fields["iono_alpha"],
                                dec.utc_iono_fields["iono_beta"])
                if out["loss_of_lock"][g, ch]:
                    f.loss_of_lock()
                    rec.observables.reset_channel(ch)

    def _pvt(self, limit: int) -> None:
        rec = self.receiver
        for rows in rec.observables.epochs_until(limit):
            for row in rows:
                row.prn = rec.fsms[row.channel].prn
            rx_tow_ms = rows[0].rx_tow_ms
            if rec._last_solve_tow_ms is not None and \
                    rx_tow_ms - rec._last_solve_tow_ms < rec.cfg.output_rate_ms:
                continue
            obs = [Observation(prn=row.prn, pseudorange_m=row.pseudorange_m,
                               eph=rec.ephemerides[row.prn],
                               doppler_hz=row.doppler_hz,
                               cn0_db_hz=row.cn0_db_hz)
                   for row in rows
                   if row.prn in rec.ephemerides and row.prn != 0]
            if len(obs) < 4:
                continue
            iono = rec.iono if rec.cfg.apply_iono else None
            sol = solve_pvt(obs, rx_tow_ms * 1e-3,
                            apply_tropo=rec.cfg.apply_tropo,
                            iono_alpha=iono[0] if iono else None,
                            iono_beta=iono[1] if iono else None)
            if sol.valid:
                rec._last_solve_tow_ms = rx_tow_ms
                rec.solutions.append(sol)

    # -- driver ------------------------------------------------------------
    def run(self, samples: np.ndarray):
        import time as _time

        import jax

        rec = self.receiver
        block = rec.block_samples
        pos = 0
        t_run0 = _time.perf_counter()
        # one-pass int8 ingest conversion + ONE upload of the whole
        # capture as a device-resident planar-int8 ring. In a real
        # deployment samples ARRIVE packed from the front end and are
        # staged into device memory in large chunks rather than uploaded
        # once per superblock.
        if np.iscomplexobj(samples):
            self._cap8 = quantize_i8(samples)
            self._ring = jax.device_put(np.stack(self._cap8))
        # phase A: superblocked pull-in (10 blocks = 200 ms of control
        # latency per acquisition/FSM round; per-20 ms dispatches would be
        # bound by per-call dispatch and transfer latency)
        sa = 10
        while self.fast is None and \
                pos + sa * block + rec.overlap <= len(samples):
            hi = pos + sa * block + rec.overlap
            if self._ring is not None:
                rec.process_superblock_ring(samples[pos:hi], self._ring,
                                            pos, sa)
            else:
                rec.process_superblock(samples[pos:hi], sa)
            pos += sa * block
            if self._ready_for_handoff():
                self._handoff()
        while self.fast is None and \
                pos + block + rec.overlap <= len(samples):
            rec.process_block(samples[pos: pos + block + rec.overlap])
            pos += block
            if self._ready_for_handoff():
                self._handoff()
        # phase B (phase-A observables anchors remain valid: same
        # absolute sample basis)
        t_split = _time.perf_counter()
        phase_b_samples = 0
        if self.fast is not None and self._ring is not None:
            fb = self.fast.block_samples
            base = self.handoff_sample
            # software pipelining: superblock N+1 is dispatched (async)
            # BEFORE superblock N's packed record is pulled to the host,
            # so decoder/observables/PVT host work overlaps device
            # compute. The tail runs as smaller ring superblocks (static
            # shapes 5 and 1, compile-cached) instead of per-block calls.
            pending: tuple | None = None
            while True:
                avail = (len(samples) - self.fast.overlap - base) // fb
                if avail <= 0:
                    break
                nb = self.blocks_per_call if avail >= self.blocks_per_call \
                    else (5 if avail >= 5 else 1)
                out = self._dispatch_ring(base, nb)
                if pending is not None:
                    self._consume_superblock(*pending)
                    self._pvt(base - 2 * self.fast.max_period)
                pending = (out, base, nb)
                base += nb * fb
            if pending is not None:
                self._consume_superblock(*pending)
                self._pvt(base - 2 * self.fast.max_period)
            phase_b_samples = base - self.handoff_sample
        elif self.fast is not None:
            fb = self.fast.block_samples
            base = self.handoff_sample
            while base + fb + self.fast.overlap <= len(samples):
                self._fast_block(samples, base)
                base += fb
                self._pvt(base - 2 * self.fast.max_period)
            phase_b_samples = base - self.handoff_sample
        t_end = _time.perf_counter()
        #: wall-clock split for ops/benchmarking: cold-start pull-in vs
        #: steady-state serving throughput
        self.timings = {
            "phase_a_s": t_split - t_run0,
            "phase_a_samples": pos,
            "phase_b_s": t_end - t_split,
            "phase_b_samples": phase_b_samples,
        }
        return rec.solutions

    @property
    def in_fast_mode(self) -> bool:
        return self.fast is not None

    # control-plane delegation (telecommand / monitoring surfaces)
    def channel_states(self):
        return self.receiver.channel_states()

    def apply_command(self, verb: str, args: list[str] | None = None) -> str:
        return self.receiver.apply_command(verb, args)

    @property
    def ephemerides(self):
        return self.receiver.ephemerides
