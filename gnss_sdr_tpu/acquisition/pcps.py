"""Batched PCPS (Parallel Code Phase Search) acquisition.

Array-program redesign of the reference engine
(/root/reference/src/algorithms/acquisition/gnuradio_blocks/
pcps_acquisition.cc): where the reference runs a serial per-Doppler-bin loop
inside one per-channel worker thread (acquisition_core, :615-771), here the
whole (PRN x Doppler x code-phase) grid is a single ``jit``-compiled array
program — batched FFT circular correlation:

    grid[p, d, :] = |IFFT( FFT(x * e^{-j 2 pi f_d n / fs}) * conj(FFT(c_p)) )|^2

accumulated non-coherently over dwells. Peak statistics (CFAR
max-to-input-power, pcps_acquisition.cc:511-545; first-vs-second peak,
:548-613), the Pfa->threshold inverse-gamma map (calculate_threshold, :894),
bit-transition straddling via the doubled FFT with second-half readout
(set_local_code layout, :312-345 and offset at :671), two-step fine-Doppler
refinement (:717-771) and the fork's repeat mode (:697-716, :944-947) are
all reproduced.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from scipy import special as sp_special


@dataclasses.dataclass
class AcqConfig:
    """Acquisition parameters.

    Field-for-field analogue of ``Acq_Conf``
    (/root/reference/src/algorithms/acquisition/libs/acq_conf.h:33-81).
    """

    fs: float
    samples_per_code: int
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    doppler_center: float = 0.0      # assisted / FDMA-bias Doppler center [Hz]
    sampled_ms: int = 1              # coherent integration [ms]
    ms_per_code: int = 1
    max_dwells: int = 1              # non-coherent integrations
    pfa: float = 0.0                 # 0 => use explicit threshold
    threshold: float = 0.0
    bit_transition_flag: bool = False
    use_cfar: bool = True            # CFAR max/input-power vs first/second peak
    # two-step fine-Doppler search (Acq_Conf::make_2_steps)
    make_2_steps: bool = False
    doppler_step2: float = 125.0
    num_doppler_bins_step2: int = 4
    pfa2: float = 0.0
    # fork addition: re-run the narrow-grid step (Acq_Conf::make_repeat_steps,
    # acq_conf.h:74)
    repeat_steps: bool = False
    # automatic acquisition-rate resampler bookkeeping
    # (gnss_flowgraph.cc:1027-1117): delays/stamps are scaled back to the
    # pre-decimation stream.
    use_automatic_resampler: bool = False
    resampler_ratio: float = 1.0
    resampler_latency_samples: int = 0
    code_length_chips: int = 0       # for the second-peak 1-chip exclusion zone

    @property
    def samples_per_ms(self) -> int:
        return int(round(self.samples_per_code / self.ms_per_code))

    @property
    def coherent_samples(self) -> int:
        """Replica length: one coherent-integration interval."""
        return self.sampled_ms * self.samples_per_ms

    @property
    def consumed_samples(self) -> int:
        """Samples buffered per dwell (pcps_acquisition.cc:71): doubled in
        bit-transition mode so the correlation straddles one symbol edge."""
        return self.coherent_samples * (2 if self.bit_transition_flag else 1)

    @property
    def fft_size(self) -> int:
        # pcps_acquisition.cc:85-92
        if self.sampled_ms == self.ms_per_code:
            return self.consumed_samples
        return self.consumed_samples * 2

    @property
    def effective_fft_size(self) -> int:
        return self.fft_size // 2 if self.bit_transition_flag else self.fft_size

    @property
    def num_doppler_bins(self) -> int:
        # ceil(2*doppler_max / doppler_step), pcps_acquisition.cc:264
        return int(math.ceil(2.0 * self.doppler_max / self.doppler_step))

    @property
    def samples_per_chip(self) -> int:
        """Exclusion-zone width for the second-peak statistic [samples]."""
        if self.code_length_chips <= 0:
            return 1
        return max(1, int(round(self.samples_per_code / self.code_length_chips)))

    def doppler_grid(self) -> np.ndarray:
        """Coarse grid: -doppler_max + center + step*i (pcps_acquisition.cc:302)."""
        i = np.arange(self.num_doppler_bins)
        return (-self.doppler_max + self.doppler_center
                + self.doppler_step * i).astype(np.float32)

    def doppler_grid_step2(self, center: float) -> np.ndarray:
        """Narrow grid centered on the coarse estimate (:313, :500)."""
        i = np.arange(self.num_doppler_bins_step2)
        return (center + (i - math.floor(self.num_doppler_bins_step2 / 2.0))
                * self.doppler_step2).astype(np.float32)

    def calculate_threshold(self, step_two: bool = False) -> float:
        """Pfa -> detection threshold (pcps_acquisition.cc:894-910)."""
        pfa = self.pfa2 if step_two else self.pfa
        if pfa <= 0.0:
            return self.threshold
        nbins = (self.num_doppler_bins_step2 if step_two
                 else self.num_doppler_bins)
        num_cells = self.effective_fft_size * nbins
        dwells_eff = 1 if self.bit_transition_flag else self.max_dwells
        q = (1.0 - pfa) ** (1.0 / num_cells)
        return float(2.0 * sp_special.gammaincinv(2.0 * dwells_eff, q))


@dataclasses.dataclass
class AcqResult:
    """Per-satellite acquisition verdict (fills GnssSynchro Acq_* fields)."""

    prn: int
    positive: bool
    test_statistic: float
    threshold: float
    delay_samples: float
    doppler_hz: float
    doppler_step: float
    samplestamp_samples: int
    grid: np.ndarray | None = None  # [D, eff] magnitude grid (dump)


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------


def wipeoff_spectra(x_re: jax.Array, x_im: jax.Array, dopplers: jax.Array,
                    fs: jax.Array) -> jax.Array:
    """FFT(x . e^{-j 2 pi f_d n / fs}) per Doppler bin: [D, N] complex64.

    Shared by the PCPS grid and its variants (acquisition/variants.py).
    """
    n = jnp.arange(x_re.shape[-1], dtype=jnp.float32)
    phase = (-2.0 * jnp.pi / fs) * dopplers[:, None] * n[None, :]
    x = jax.lax.complex(x_re, x_im)
    return jnp.fft.fft(x * jax.lax.complex(jnp.cos(phase), jnp.sin(phase)),
                       axis=-1)


@functools.partial(jax.jit, static_argnames=("offset", "eff"))
def _pcps_magnitude_grid(
    x_re: jax.Array,        # [N] float32, zero-padded to fft_size
    x_im: jax.Array,        # [N] float32
    code_fft_re: jax.Array,  # [P, N] float32: conj(FFT(local code layout))
    code_fft_im: jax.Array,  # [P, N] float32
    dopplers: jax.Array,    # [D] float32
    fs: jax.Array,          # scalar float32
    offset: int,
    eff: int,
) -> jax.Array:
    """|IFFT(FFT(x . wipeoff) . conj(FFT(code)))|^2 for all (PRN, Doppler).

    One fused batched program over the whole search grid, replacing the
    reference's serial per-Doppler-bin FFTW loop
    (pcps_acquisition.cc:655-687). Inputs and outputs are planar float32;
    the transforms run in complex64 (cuFFT on a GPU).
    """
    spectra = wipeoff_spectra(x_re, x_im, dopplers, fs)          # [D, N]
    code = jax.lax.complex(code_fft_re, code_fft_im)              # [P, N]
    corr = jnp.fft.ifft(spectra[None, :, :] * code[:, None, :], axis=-1)
    corr = corr[..., offset:offset + eff]                        # [P, D, eff]
    return corr.real * corr.real + corr.imag * corr.imag


def magnitude_grid_reference(x: np.ndarray, code_fft: np.ndarray,
                             dopplers: np.ndarray, fs: float, offset: int,
                             eff: int) -> np.ndarray:
    """Plain float64 NumPy counterpart of :func:`_pcps_magnitude_grid`
    (``x`` [N] and ``code_fft`` [P, N] complex): the reference the device
    grid is checked against."""
    x = np.asarray(x, dtype=np.complex128)
    n = np.arange(x.shape[-1], dtype=np.float64)
    wipe = np.exp(-2j * np.pi * np.asarray(dopplers, np.float64)[:, None]
                  * n[None, :] / fs)
    spectra = np.fft.fft(x[None, :] * wipe, axis=-1)
    corr = np.fft.ifft(spectra[None] * np.asarray(code_fft, np.complex128)
                       [:, None, :], axis=-1)[..., offset:offset + eff]
    return corr.real ** 2 + corr.imag ** 2


@functools.partial(jax.jit, static_argnames=("num_dwells",))
def _cfar_statistics(grid: jax.Array, num_dwells: int):
    """CFAR max-to-input-power statistic per PRN.

    Mirrors pcps_acquisition::max_to_input_power_statistic (:511-545):
    input power is the mean of the Doppler row *opposite* the peak row,
    halved and divided by the dwell count.
    """
    p, d, eff = grid.shape
    flat = grid.reshape(p, -1)
    idx = jnp.argmax(flat, axis=-1)
    index_doppler = idx // eff
    index_time = idx % eff
    peak = jnp.max(flat, axis=-1)
    opposite = (index_doppler + d // 2) % d
    row = jnp.take_along_axis(grid, opposite[:, None, None], axis=1)[:, 0, :]
    input_power = jnp.mean(row, axis=-1) / 2.0 / num_dwells
    stat = peak / jnp.maximum(input_power, jnp.finfo(jnp.float32).tiny)
    return stat, index_doppler, index_time


@functools.partial(jax.jit, static_argnames=("samples_per_chip",))
def _second_peak_statistics(grid: jax.Array, samples_per_chip: int):
    """First-vs-second-peak statistic per PRN.

    Mirrors pcps_acquisition::first_vs_second_peak_statistic (:548-613):
    the second peak is searched in the peak's Doppler row outside a
    +-1 chip exclusion zone (with circular wrap).
    """
    p, d, eff = grid.shape
    flat = grid.reshape(p, -1)
    idx = jnp.argmax(flat, axis=-1)
    index_doppler = idx // eff
    index_time = idx % eff
    first = jnp.max(flat, axis=-1)
    row = jnp.take_along_axis(grid, index_doppler[:, None, None], axis=1)[:, 0, :]
    pos = jnp.arange(eff)[None, :]
    dist = jnp.abs(pos - index_time[:, None])
    dist = jnp.minimum(dist, eff - dist)  # circular distance
    masked = jnp.where(dist > samples_per_chip, row, 0.0)
    second = jnp.max(masked, axis=-1)
    stat = first / jnp.maximum(second, jnp.finfo(jnp.float32).tiny)
    return stat, index_doppler, index_time


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class PcpsAcquisition:
    """Batched multi-satellite PCPS acquisition engine.

    ``codes`` maps PRN -> complex64 replica sampled at ``cfg.fs`` over one
    coherent-integration interval (``consumed_samples`` samples). The engine
    pre-computes conj(FFT) of each replica using the reference's buffer
    layout (set_local_code, pcps_acquisition.cc:312-345): with
    ``bit_transition_flag`` the code occupies the second half of a
    double-length buffer and correlation magnitudes are read from the
    second half of the IFFT.
    """

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray]):
        self.cfg = cfg
        self.prns = sorted(codes)
        n = cfg.coherent_samples
        fft_size = cfg.fft_size

        layouts = np.zeros((len(self.prns), fft_size), dtype=np.complex64)
        for row, prn in enumerate(self.prns):
            code = np.asarray(codes[prn], dtype=np.complex64)
            if code.shape[0] != n:
                raise ValueError(
                    f"PRN {prn}: replica must have {n} samples, got {code.shape[0]}"
                )
            # set_local_code buffer layouts (pcps_acquisition.cc:186-209)
            if cfg.bit_transition_flag:
                layouts[row, fft_size // 2: fft_size // 2 + n] = code
            elif cfg.sampled_ms == cfg.ms_per_code:
                layouts[row, :] = code
            else:
                layouts[row, fft_size - n:] = code
        code_ffts = np.conj(np.fft.fft(layouts, axis=-1))  # host-side numpy
        self._code_fft_re = jnp.asarray(
            np.ascontiguousarray(code_ffts.real, dtype=np.float32))
        self._code_fft_im = jnp.asarray(
            np.ascontiguousarray(code_ffts.imag, dtype=np.float32))
        self._dopplers = jnp.asarray(cfg.doppler_grid())
        self._fs = jnp.float32(cfg.fs)
        self._offset = cfg.effective_fft_size if cfg.bit_transition_flag else 0
        self._eff = cfg.effective_fft_size
        self._samples_per_chip = cfg.samples_per_chip

    # -- internals --------------------------------------------------------
    def _prepare_buffer(self, samples: np.ndarray, dwell: int):
        cfg = self.cfg
        n = cfg.consumed_samples
        start = dwell * n
        seg = np.asarray(samples[start:start + n], dtype=np.complex64)
        if seg.shape[0] < cfg.fft_size:
            seg = np.pad(seg, (0, cfg.fft_size - seg.shape[0]))
        return (jnp.asarray(np.ascontiguousarray(seg.real, dtype=np.float32)),
                jnp.asarray(np.ascontiguousarray(seg.imag, dtype=np.float32)))

    def _grid(self, x, dopplers: jnp.ndarray) -> jnp.ndarray:
        return _pcps_magnitude_grid(
            x[0], x[1], self._code_fft_re, self._code_fft_im, dopplers,
            self._fs, offset=self._offset, eff=self._eff,
        )

    def _evaluate(
        self, grid_sum: jnp.ndarray, dopplers: np.ndarray, num_dwells: int
    ):
        if self.cfg.use_cfar:
            stat, i_dop, i_time = _cfar_statistics(grid_sum, num_dwells)
        else:
            stat, i_dop, i_time = _second_peak_statistics(
                grid_sum, self._samples_per_chip
            )
        stat = np.asarray(stat)
        i_dop = np.asarray(i_dop)
        i_time = np.asarray(i_time)
        doppler_hz = dopplers[i_dop]
        return stat, doppler_hz, i_time

    def _make_result(
        self, prn, positive, stat, threshold, i_time, doppler_hz,
        doppler_step, samplestamp, grid=None,
    ) -> AcqResult:
        cfg = self.cfg
        # Replicas are digitized with the floor (chip-at-sample-start)
        # convention (codes/sampling.py sample_code_floor), matching the
        # incoming signal and the tracking resampler, so the peak index
        # IS the unbiased delay. (The reference's AUX_CEIL replica lands
        # one sample late and absorbs it in DLL pull-in,
        # gps_sdr_signal_replica.cc:159-176 — at wide-band sample/chip
        # ratios that bias exceeds half a chip, so we fixed the replica
        # instead; VERDICT r4 item 7.)
        delay = float(np.fmod(np.float32(i_time),
                              np.float32(cfg.samples_per_code)))
        if cfg.use_automatic_resampler:
            delay = delay * cfg.resampler_ratio - cfg.resampler_latency_samples
            samplestamp = int(round(samplestamp * cfg.resampler_ratio))
        return AcqResult(
            prn=prn, positive=bool(positive), test_statistic=float(stat),
            threshold=float(threshold), delay_samples=delay,
            doppler_hz=float(doppler_hz), doppler_step=float(doppler_step),
            samplestamp_samples=int(samplestamp), grid=grid,
        )

    # -- public API -------------------------------------------------------
    def search(
        self,
        samples: np.ndarray,
        samplestamp: int = 0,
        dump_grids: bool = False,
    ) -> dict[int, AcqResult]:
        """Run a full acquisition (all dwells, optional two-step) on a buffer.

        ``samples`` must hold at least ``max_dwells * consumed_samples``
        samples for full non-coherent integration; fewer samples reduce the
        dwell count like a stream that ends. Returns one AcqResult per PRN.
        """
        cfg = self.cfg
        threshold = cfg.calculate_threshold(step_two=False)
        avail_dwells = max(1, min(cfg.max_dwells,
                                  len(samples) // cfg.consumed_samples))
        dopplers = np.asarray(self._dopplers)

        grid_sum = None
        decided: dict[int, AcqResult] = {}
        pending = list(self.prns)
        for dwell in range(avail_dwells):
            x = self._prepare_buffer(samples, dwell)
            g = self._grid(x, self._dopplers)
            grid_sum = g if grid_sum is None else grid_sum + g
            stat, doppler_hz, i_time = self._evaluate(
                grid_sum, dopplers, dwell + 1
            )
            last = dwell == avail_dwells - 1
            for row, prn in enumerate(self.prns):
                if prn not in pending:
                    continue
                if stat[row] > threshold:
                    pending.remove(prn)
                    decided[prn] = self._make_result(
                        prn, True, stat[row], threshold, i_time[row],
                        doppler_hz[row], cfg.doppler_step, samplestamp,
                        grid=np.asarray(grid_sum[row]) if dump_grids else None,
                    )
                elif last:
                    decided[prn] = self._make_result(
                        prn, False, stat[row], threshold, i_time[row],
                        doppler_hz[row], cfg.doppler_step, samplestamp,
                        grid=np.asarray(grid_sum[row]) if dump_grids else None,
                    )

        if cfg.make_2_steps:
            n_refines = 2 if cfg.repeat_steps else 1
            for prn in list(decided):
                res = decided[prn]
                if not res.positive:
                    continue
                for _ in range(n_refines):
                    res = self._refine(samples, res, samplestamp, dump_grids)
                decided[prn] = res
        return decided

    def _refine(
        self, samples: np.ndarray, coarse: AcqResult, samplestamp: int,
        dump_grids: bool,
    ) -> AcqResult:
        """Two-step narrow-grid Doppler refinement (pcps_acquisition.cc:717-771)."""
        cfg = self.cfg
        threshold2 = cfg.calculate_threshold(step_two=True)
        dopplers2 = cfg.doppler_grid_step2(coarse.doppler_hz)
        row = self.prns.index(coarse.prn)
        cf_re = self._code_fft_re[row:row + 1]
        cf_im = self._code_fft_im[row:row + 1]

        grid_sum = None
        avail_dwells = max(1, min(cfg.max_dwells,
                                  len(samples) // cfg.consumed_samples))
        for dwell in range(avail_dwells):
            x = self._prepare_buffer(samples, dwell)
            g = _pcps_magnitude_grid(
                x[0], x[1], cf_re, cf_im, jnp.asarray(dopplers2), self._fs,
                offset=self._offset, eff=self._eff,
            )
            grid_sum = g if grid_sum is None else grid_sum + g

        if cfg.use_cfar:
            stat, i_dop, i_time = _cfar_statistics(grid_sum, avail_dwells)
        else:
            stat, i_dop, i_time = _second_peak_statistics(
                grid_sum, self._samples_per_chip
            )
        stat = float(np.asarray(stat)[0])
        i_time = int(np.asarray(i_time)[0])
        doppler_hz = float(dopplers2[int(np.asarray(i_dop)[0])])
        positive = stat > threshold2
        result = self._make_result(
            coarse.prn, positive, stat, threshold2, i_time,
            doppler_hz if positive else coarse.doppler_hz,
            cfg.doppler_step2, samplestamp,
            grid=np.asarray(grid_sum[0]) if dump_grids else None,
        )
        if not positive:
            # failed refinement falls back to the coarse verdict
            result = dataclasses.replace(
                coarse, doppler_step=cfg.doppler_step,
            )
        return result
