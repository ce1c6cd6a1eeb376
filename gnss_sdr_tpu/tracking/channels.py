"""Host-side multi-channel tracking wrapper.

Owns the 64-bit absolute bookkeeping the device program deliberately avoids
(sample counters, accumulated carrier phase) and the acquisition->tracking
pull-in alignment (dll_pll_veml_tracking.cc:1813-1844). Emits per-PRN-period
records equivalent to the reference's ``Gnss_Synchro`` output stream.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np

from gnss_sdr_tpu.tracking.engine import TrackingConfig, TrackingEngine

TWO_PI = 2.0 * math.pi


@functools.lru_cache(maxsize=1)
def _dequant_fn():
    import jax

    def dequant(i8, scale):
        return i8.astype(jnp.float32) * scale

    return jax.jit(dequant)


def quantized_planar(seg: np.ndarray, bits_rms: float = 16.0):
    """Host->device IF ingest as int8 with a per-block scale.

    GNSS IF samples carry 1-8 significant bits (the reference's native
    packed formats, SURVEY section 2.2); shipping float32 planar wastes
    4x the host->device bandwidth, which is the e2e bottleneck when the
    accelerator sits behind a narrow link. Quantizing at rms/16 puts the
    quantization noise ~45 dB under the thermal floor; dequantization is
    a device-side multiply."""
    re = np.ascontiguousarray(seg.real, np.float32)
    im = np.ascontiguousarray(seg.imag, np.float32)
    rms = float(np.sqrt(np.mean(re * re + im * im))) or 1.0
    q = rms / bits_rms
    r8 = np.clip(np.round(re / q), -127, 127).astype(np.int8)
    i8 = np.clip(np.round(im / q), -127, 127).astype(np.int8)
    dq = _dequant_fn()
    scale = jnp.float32(q)
    return dq(jnp.asarray(r8), scale), dq(jnp.asarray(i8), scale)


@dataclasses.dataclass
class PeriodOutput:
    """One PRN period's tracking output (a Gnss_Synchro row)."""

    channel: int
    prn: int
    sample_start: int            # absolute sample index of period start
    length: int
    rem_code_phase_samples: float
    prompt: complex
    corr: np.ndarray             # all taps [T]
    carrier_doppler_hz: float
    code_freq_chips: float
    acc_carrier_phase_rad: float  # accumulated (64-bit, host)
    cn0_db_hz: float
    carrier_lock_test: float
    evm: float
    loss_of_lock: bool
    #: data-component prompt (== prompt unless cfg.track_pilot;
    #: dll_pll d_correlator_data role)
    data_prompt: complex = 0j


class TrackingChannels:
    """N tracking channels over a block-streamed sample source."""

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 block_samples: int):
        self.cfg = cfg
        self.engine = TrackingEngine(cfg, n_channels, block_samples)
        self.state = self.engine.init_state()
        self.n_channels = n_channels
        self.block_samples = block_samples
        self.overlap = self.engine.overlap
        self.abs_block_start = 0  # absolute sample index of next block
        self._code_tables = np.zeros(
            (n_channels, cfg.code_length_chips * cfg.code_samples_per_chip),
            dtype=np.float32)
        self._code_tables_dev = jnp.asarray(self._code_tables)
        if cfg.track_pilot:
            self._data_code_tables = np.zeros_like(self._code_tables)
            self._data_code_tables_dev = jnp.asarray(self._data_code_tables)
        else:
            self._data_code_tables = None
            self._data_code_tables_dev = None
        self.prn = [0] * n_channels
        self.acc_carrier_phase_rad = np.zeros(n_channels, dtype=np.float64)

    # -- channel management ------------------------------------------------
    def start_channel(
        self, ch: int, prn: int, code_table: np.ndarray,
        acq_delay_samples: float, acq_doppler_hz: float,
        acq_samplestamp: int, if_freq_hz: float = 0.0,
        data_code_table: np.ndarray | None = None,
    ) -> None:
        """Assign a satellite to channel ``ch`` after positive acquisition.

        Pull-in alignment (the reference's tracking state 1): skip to the
        first code-period boundary at or after the next block start.
        ``acq_delay_samples`` is the code phase at ``acq_samplestamp``.
        """
        cfg = self.cfg
        t_prn_samples = cfg.fs * cfg.code_length_chips / cfg.chip_rate_cps
        # delta between the stream position where tracking resumes and the
        # acquisition-reported PRN start
        delta = (self.abs_block_start - acq_samplestamp) - acq_delay_samples
        acq_code_phase = t_prn_samples - math.fmod(delta, t_prn_samples)
        if acq_code_phase >= t_prn_samples:
            acq_code_phase -= t_prn_samples
        offset = int(round(acq_code_phase))
        self._code_tables[ch] = code_table.astype(np.float32)
        self._code_tables_dev = jnp.asarray(self._code_tables)
        if self.cfg.track_pilot:
            if data_code_table is None:
                raise ValueError("track_pilot channels need data_code_table")
            self._data_code_tables[ch] = data_code_table.astype(np.float32)
            self._data_code_tables_dev = jnp.asarray(self._data_code_tables)
        self.state = self.engine.start_channel(
            self.state, ch, acq_doppler_hz, offset,
            int(round(t_prn_samples)), if_freq_hz=if_freq_hz,
        )
        self.prn[ch] = prn
        self.acc_carrier_phase_rad[ch] = 0.0

    def stop_channel(self, ch: int) -> None:
        self.state = self.engine.stop_channel(self.state, ch)
        self.prn[ch] = 0

    def enable_extended(self, ch: int, periods_into_group: int = 0) -> None:
        """Enable extended coherent integration for a channel (host-side
        state-machine decision after bit sync)."""
        self.state = self.engine.set_extended(
            self.state, ch, periods_into_group)

    @property
    def active_mask(self) -> np.ndarray:
        return np.asarray(self.state.active)

    # -- streaming ---------------------------------------------------------
    def process_block(self, block: np.ndarray) -> list[list[PeriodOutput]]:
        """Track one block (block_samples + overlap input samples).

        Returns per-channel lists of period outputs in time order, with
        absolute sample stamps.
        """
        block_start = self.abs_block_start
        block = np.asarray(block)
        block_re = jnp.asarray(
            np.ascontiguousarray(block.real, dtype=np.float32))
        block_im = jnp.asarray(
            np.ascontiguousarray(block.imag, dtype=np.float32))
        self.state, out = self.engine.process_block(
            self.state, block_re, block_im, self._code_tables_dev,
            self._data_code_tables_dev)
        self.abs_block_start += self.block_samples
        return self._emit(np.asarray(out["packed"]), block_start)

    def process_superblock(self, seg: np.ndarray, n_blocks: int,
                           i8: tuple[np.ndarray, np.ndarray] | None = None
                           ) -> list[list[PeriodOutput]]:
        """Track ``n_blocks`` consecutive blocks in one device call (the
        engine's superblock program): dispatch latency amortizes across
        the segment, which keeps cold-start pull-in from being bound by
        per-call dispatch and transfer latency. ``seg`` must hold
        ``n_blocks * block_samples + overlap`` samples; ``i8`` optionally
        carries the same span pre-quantized as planar int8 (skips the
        per-call quantization pass AND quarters the upload)."""
        base = self.abs_block_start
        bs = self.block_samples
        n_in = bs + self.overlap
        if i8 is not None:
            both = np.stack([
                np.stack([i8[0][b * bs: b * bs + n_in]
                          for b in range(n_blocks)]),
                np.stack([i8[1][b * bs: b * bs + n_in]
                          for b in range(n_blocks)])])
            args = (jnp.asarray(both),)
            step = self.engine._superblock_step_i8
        else:
            seg = np.asarray(seg)
            blocks = np.stack([seg[b * bs: b * bs + n_in]
                               for b in range(n_blocks)])
            args = quantized_planar(blocks)
            step = self.engine._superblock_step
        if self.cfg.track_pilot:
            self.state, out = step(self.state, *args,
                                   self._code_tables_dev,
                                   self._data_code_tables_dev)
        else:
            self.state, out = step(self.state, *args,
                                   self._code_tables_dev)
        self.abs_block_start += n_blocks * bs
        packed = np.asarray(out["packed"])     # ONE device->host transfer
        results: list[list[PeriodOutput]] = [
            [] for _ in range(self.n_channels)]
        for b in range(n_blocks):
            for ch, lst in enumerate(self._emit(packed[b], base + b * bs)):
                results[ch].extend(lst)
        return results

    def process_superblock_ring(self, ring_dev, base: int, n_blocks: int
                                ) -> list[list[PeriodOutput]]:
        """Track ``n_blocks`` blocks sliced ON DEVICE from a resident
        planar-int8 ring ([2, L]); ``base`` is the ring index of the first
        block (== absolute sample index when the ring holds the whole
        capture). Avoids all per-call host->device uploads (see
        TrackingEngine._superblock_ring_i8)."""
        abs_base = self.abs_block_start
        bs = self.block_samples
        import jax.numpy as jnp

        args = (self.state, ring_dev, jnp.int32(base), int(n_blocks),
                self._code_tables_dev)
        if self.cfg.track_pilot:
            args = args + (self._data_code_tables_dev,)
        self.state, out = self.engine._superblock_ring_i8(*args)
        self.abs_block_start += n_blocks * bs
        packed = np.asarray(out["packed"])     # ONE device->host transfer
        results: list[list[PeriodOutput]] = [
            [] for _ in range(self.n_channels)]
        for b in range(n_blocks):
            for ch, lst in enumerate(self._emit(packed[b], abs_base + b * bs)):
                results[ch].extend(lst)
        return results

    def _emit(self, packed: np.ndarray,
              block_start: int) -> list[list[PeriodOutput]]:
        """Expand the engine's packed per-period record [S, C, W] into
        PeriodOutput rows (layout documented at the engine's ``packed``
        output)."""
        results: list[list[PeriodOutput]] = [[] for _ in range(self.n_channels)]
        n_taps = self.cfg.n_taps
        chip_rate = self.cfg.chip_rate_cps
        n_steps = packed.shape[0]
        for step in range(n_steps):
            row = packed[step]
            for ch in np.nonzero(row[:, 0] > 0.5)[0]:
                r = row[ch]
                self.acc_carrier_phase_rad[ch] -= float(r[10])
                results[ch].append(PeriodOutput(
                    channel=int(ch),
                    prn=self.prn[ch],
                    sample_start=block_start + int(r[1]),
                    length=int(r[2]),
                    rem_code_phase_samples=float(r[3]),
                    prompt=complex(r[4], r[5]),
                    data_prompt=complex(r[6], r[7]),
                    corr=(r[15:15 + n_taps]
                          + 1j * r[15 + n_taps:15 + 2 * n_taps]),
                    carrier_doppler_hz=float(r[8]),
                    code_freq_chips=chip_rate + float(r[9]),
                    acc_carrier_phase_rad=float(
                        self.acc_carrier_phase_rad[ch]),
                    cn0_db_hz=float(r[11]),
                    carrier_lock_test=float(r[12]),
                    evm=float(r[13]),
                    loss_of_lock=bool(r[14] > 0.5),
                ))
        return results
