"""Alternative acquisition search strategies: QuickSync and CCCWSR.

Counterparts of the reference variant engines
(reference: src/algorithms/acquisition/gnuradio_blocks/
pcps_quicksync_acquisition_cc.cc — S-fold the signal to shorten the FFT —
and pcps_cccwsr_acquisition_cc.cc — Coherent Channel Combining With Sign
Recovery for BOC-ambiguous pilot+data signals like Galileo E1).

Both reuse the batched FFT grid machinery of the PCPS engine: the whole
(PRN x Doppler x code-phase) search stays one jitted array program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sdr_tpu.acquisition.pcps import (
    AcqConfig, AcqResult, PcpsAcquisition, _cfar_statistics,
    _second_peak_statistics, wipeoff_spectra)


# ---------------------------------------------------------------------------
# QuickSync: fold-by-S then short-FFT correlation + candidate disambiguation
# ---------------------------------------------------------------------------


@jax.jit
def _folded_grid(x_re, x_im, code_fft_re, code_fft_im, dopplers, fs):
    """|IFFT(FFT(fold(x . wipeoff)) . conj(FFT(folded code)))|^2.

    x is [S, N/S] pre-split; folding sums the S segments after carrier
    wipe-off (the wipe-off must happen before folding because the carrier
    phase differs between segments).
    """
    s, nf = x_re.shape
    n = jnp.arange(s * nf, dtype=jnp.float32).reshape(s, nf)
    phase = (-2.0 * jnp.pi / fs) * dopplers[:, None, None] * n[None, :, :]
    x = jax.lax.complex(x_re, x_im)[None]
    folded = jnp.sum(x * jax.lax.complex(jnp.cos(phase), jnp.sin(phase)),
                     axis=1)                                  # [D, N/S]
    spectra = jnp.fft.fft(folded, axis=-1)
    code = jax.lax.complex(code_fft_re, code_fft_im)
    corr = jnp.fft.ifft(spectra[None] * code[:, None], axis=-1)  # [P, D, N/S]
    return corr.real ** 2 + corr.imag ** 2


class QuickSyncAcquisition:
    """S-fold PCPS: the FFT length drops from N to N/S (S^2 fewer
    butterfly ops per bin) at ~10 log10(S) dB sensitivity cost; the code
    phase comes out modulo N/S and is disambiguated by testing the S
    candidate delays with direct correlations against the unfolded
    replica (pcps_quicksync_acquisition_cc 'folding_factor' semantics)."""

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray],
                 folding_factor: int = 2):
        self.cfg = cfg
        self.prns = sorted(codes)
        self.folding_factor = int(folding_factor)
        n = cfg.coherent_samples
        if n % self.folding_factor:
            raise ValueError("folding factor must divide the coherent length")
        self.n_folded = n // self.folding_factor
        folded = np.zeros((len(self.prns), self.n_folded), dtype=np.complex64)
        self._full_codes = {}
        for row, prn in enumerate(self.prns):
            code = np.asarray(codes[prn], dtype=np.complex64)
            if code.shape[0] != n:
                raise ValueError(f"PRN {prn}: replica must have {n} samples")
            folded[row] = code.reshape(self.folding_factor, -1).sum(axis=0)
            self._full_codes[prn] = code
        code_ffts = np.conj(np.fft.fft(folded, axis=-1))
        self._cf_re = jnp.asarray(code_ffts.real.astype(np.float32))
        self._cf_im = jnp.asarray(code_ffts.imag.astype(np.float32))
        self._dopplers = jnp.asarray(cfg.doppler_grid())
        self._fs = jnp.float32(cfg.fs)

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        n = cfg.coherent_samples
        seg = np.asarray(samples[:n], dtype=np.complex64)
        if seg.shape[0] < n:
            seg = np.pad(seg, (0, n - seg.shape[0]))
        xs = seg.reshape(self.folding_factor, -1)
        grid = _folded_grid(
            jnp.asarray(xs.real.astype(np.float32)),
            jnp.asarray(xs.imag.astype(np.float32)),
            self._cf_re, self._cf_im, self._dopplers, self._fs)
        if cfg.use_cfar:
            stat, i_dop, i_time = _cfar_statistics(grid, 1)
        else:
            stat, i_dop, i_time = _second_peak_statistics(
                grid, cfg.samples_per_chip)
        stat = np.asarray(stat)
        i_dop = np.asarray(i_dop)
        i_time = np.asarray(i_time)
        dopplers = np.asarray(self._dopplers)
        threshold = cfg.calculate_threshold()
        t = np.arange(n, dtype=np.float64)
        out: dict[int, AcqResult] = {}
        for row, prn in enumerate(self.prns):
            doppler = float(dopplers[i_dop[row]])
            # disambiguate delay among the S candidates (host: S tiny dots)
            wipe = seg * np.exp(-2j * np.pi * doppler / cfg.fs * t)
            best_mag, best_delay = -1.0, 0
            for k in range(self.folding_factor):
                delay = int(i_time[row]) + k * self.n_folded
                rolled = np.roll(self._full_codes[prn], delay)
                mag = abs(np.vdot(rolled, wipe))
                if mag > best_mag:
                    best_mag, best_delay = mag, delay
            out[prn] = AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(best_delay % cfg.samples_per_code),
                doppler_hz=doppler, doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
        return out


# ---------------------------------------------------------------------------
# CCCWSR: coherent data+pilot combining with sign recovery
# ---------------------------------------------------------------------------


@jax.jit
def _cccwsr_grid(x_re, x_im, cb_re, cb_im, cc_re, cc_im, dopplers, fs):
    """max(|corr_B + corr_C|^2, |corr_B - corr_C|^2) over the grid.

    The relative sign between the E1-B data chip and the E1-C secondary
    chip is unknown at acquisition; testing both signs recovers the full
    coherent gain of the two-channel combination
    (pcps_cccwsr_acquisition_cc.cc core idea)."""
    sp = wipeoff_spectra(x_re, x_im, dopplers, fs)[None]      # [1, D, N]
    yb = jnp.fft.ifft(sp * jax.lax.complex(cb_re, cb_im)[:, None], axis=-1)
    yc = jnp.fft.ifft(sp * jax.lax.complex(cc_re, cc_im)[:, None], axis=-1)
    plus, minus = yb + yc, yb - yc                            # [P, D, N]
    return jnp.maximum(plus.real ** 2 + plus.imag ** 2,
                       minus.real ** 2 + minus.imag ** 2)


class CccwsrAcquisition:
    """Data+pilot coherent-combining acquisition (Galileo E1 B+C)."""

    def __init__(self, cfg: AcqConfig, data_codes: dict[int, np.ndarray],
                 pilot_codes: dict[int, np.ndarray]):
        if sorted(data_codes) != sorted(pilot_codes):
            raise ValueError("data and pilot PRN sets must match")
        self.cfg = cfg
        self.prns = sorted(data_codes)
        n = cfg.coherent_samples
        fb = np.zeros((len(self.prns), n), dtype=np.complex64)
        fc = np.zeros_like(fb)
        for row, prn in enumerate(self.prns):
            fb[row] = np.asarray(data_codes[prn], dtype=np.complex64)
            fc[row] = np.asarray(pilot_codes[prn], dtype=np.complex64)
        cfb = np.conj(np.fft.fft(fb, axis=-1))
        cfc = np.conj(np.fft.fft(fc, axis=-1))
        self._cb = (jnp.asarray(cfb.real.astype(np.float32)),
                    jnp.asarray(cfb.imag.astype(np.float32)))
        self._cc = (jnp.asarray(cfc.real.astype(np.float32)),
                    jnp.asarray(cfc.imag.astype(np.float32)))
        self._dopplers = jnp.asarray(cfg.doppler_grid())
        self._fs = jnp.float32(cfg.fs)

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        n = cfg.coherent_samples
        seg = np.asarray(samples[:n], dtype=np.complex64)
        if seg.shape[0] < n:
            seg = np.pad(seg, (0, n - seg.shape[0]))
        grid = _cccwsr_grid(
            jnp.asarray(seg.real.astype(np.float32)),
            jnp.asarray(seg.imag.astype(np.float32)),
            self._cb[0], self._cb[1], self._cc[0], self._cc[1],
            self._dopplers, self._fs)
        if cfg.use_cfar:
            stat, i_dop, i_time = _cfar_statistics(grid, 1)
        else:
            stat, i_dop, i_time = _second_peak_statistics(
                grid, cfg.samples_per_chip)
        stat = np.asarray(stat)
        i_dop = np.asarray(i_dop)
        i_time = np.asarray(i_time)
        dopplers = np.asarray(self._dopplers)
        threshold = cfg.calculate_threshold()
        return {
            prn: AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(int(i_time[row]) % cfg.samples_per_code),
                doppler_hz=float(dopplers[i_dop[row]]),
                doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
            for row, prn in enumerate(self.prns)
        }


class NoncoherentIQCafAcquisition:
    """Galileo E5a noncoherent I/Q acquisition with the CAF Doppler filter.

    Counterpart of ``galileo_e5a_noncoherent_iq_acquisition_caf_cc``
    (/root/reference/src/algorithms/acquisition/gnuradio_blocks/
    galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc): correlate the E5a-I
    (data) and E5a-Q (pilot) primary codes separately, sum the magnitude
    grids non-coherently (``both_signal_components``, :117-138,:538-546),
    take the peak, and — when ``caf_window_hz > 0`` — refine the Doppler
    by smoothing the per-bin peak-magnitude profile with the reference's
    triangular CAF window (weights 1 - 0.5|di|/half, edge-normalized,
    :599-661) and re-selecting the argmax.
    """

    def __init__(self, cfg: AcqConfig, data_codes: dict[int, np.ndarray],
                 pilot_codes: dict[int, np.ndarray],
                 both_signal_components: bool = True,
                 caf_window_hz: float = 0.0):
        from gnss_sdr_tpu.acquisition.pcps import PcpsAcquisition

        self.cfg = cfg
        self.prns = sorted(data_codes)
        self.both = both_signal_components
        self.caf_window_hz = float(caf_window_hz)
        self._eng_i = PcpsAcquisition(cfg, data_codes)
        self._eng_q = PcpsAcquisition(cfg, pilot_codes) \
            if both_signal_components else None

    def _caf_refine(self, grid: np.ndarray, dopplers: np.ndarray
                    ) -> np.ndarray:
        """Per-PRN refined Doppler from the triangular-weighted moving
        average of the per-bin peak magnitudes."""
        half = int(self.caf_window_hz / (2.0 * self.cfg.doppler_step))
        prof = grid.max(axis=-1)                       # [P, D]
        if half < 1:
            return dopplers[np.argmax(prof, axis=-1)]
        w = 0.5 / half
        offs = np.arange(-half, half + 1)
        weights = 1.0 - w * np.abs(offs)
        smoothed = np.empty_like(prof)
        d_bins = prof.shape[1]
        for d in range(d_bins):
            lo = max(0, d - half)
            hi = min(d_bins, d + half + 1)
            ww = weights[(lo - d + half):(hi - d + half)]
            smoothed[:, d] = prof[:, lo:hi] @ ww / ww.sum()
        return dopplers[np.argmax(smoothed, axis=-1)]

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        dwells = max(1, min(cfg.max_dwells,
                            len(samples) // cfg.consumed_samples))
        grid_sum = None
        for dwell in range(dwells):
            x = self._eng_i._prepare_buffer(samples, dwell)
            g = np.asarray(self._eng_i._grid(x, self._eng_i._dopplers))
            if self._eng_q is not None:
                g = g + np.asarray(self._eng_q._grid(
                    x, self._eng_q._dopplers))
            grid_sum = g if grid_sum is None else grid_sum + g
        if cfg.use_cfar:
            stat, i_dop, i_time = _cfar_statistics(
                jnp.asarray(grid_sum), dwells)
        else:
            stat, i_dop, i_time = _second_peak_statistics(
                jnp.asarray(grid_sum), cfg.samples_per_chip)
        stat = np.asarray(stat)
        i_dop = np.asarray(i_dop)
        i_time = np.asarray(i_time)
        dopplers = np.asarray(self._eng_i._dopplers)
        dopp = dopplers[i_dop].astype(float)
        if self.caf_window_hz > 0:
            dopp = self._caf_refine(grid_sum, dopplers)
        threshold = cfg.calculate_threshold()
        return {
            prn: AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(int(i_time[row]) % cfg.samples_per_code),
                doppler_hz=float(np.atleast_1d(dopp)[row]),
                doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
            for row, prn in enumerate(self.prns)
        }
