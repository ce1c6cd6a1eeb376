"""Tong sequential-detection acquisition.

Counterpart of pcps_tong_acquisition_cc
(/root/reference/src/algorithms/acquisition/gnuradio_blocks/
pcps_tong_acquisition_cc.cc): per one-code-period dwell the magnitude
grid — normalized by that dwell's input power (:283-286, :312-317) — is
accumulated per Doppler bin, and a counting detector walks up on
``stat > threshold * dwell_count`` (+1, declare positive at
``tong_max_val``) or down (-1, declare negative at 0), with a
``tong_max_dwells`` cap forcing a negative (:352-371). Default knobs
follow the adapter (gps_l1_ca_pcps_tong_acquisition.cc:66-68).

Device mapping: all PRNs share one batched grid program per dwell (the
reference runs one satellite per block instance); the per-PRN Tong
counters are scalar host state. The accumulated grid stays on device
between dwells.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu.acquisition.pcps import AcqConfig, AcqResult, PcpsAcquisition


class TongAcquisition:
    """Sequential (Tong) detector over the batched PCPS magnitude grid."""

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray],
                 tong_init_val: int = 1, tong_max_val: int = 2,
                 tong_max_dwells: int | None = None,
                 threshold: float | None = None):
        self._pcps = PcpsAcquisition(cfg, codes)
        self.cfg = cfg
        self.prns = self._pcps.prns
        self.tong_init_val = int(tong_init_val)
        self.tong_max_val = int(tong_max_val)
        self.tong_max_dwells = int(tong_max_dwells
                                   if tong_max_dwells is not None
                                   else tong_max_val + 1)
        # the reference Tong adapter takes an absolute threshold on the
        # power-normalized accumulated peak; fall back to the Pfa-derived
        # per-cell threshold when not given
        self.threshold = float(threshold if threshold is not None
                               else cfg.calculate_threshold())
        self.reset()

    def reset(self) -> None:
        """set_state(1) semantics (:188-207): zero the accumulated grid
        and reinitialize every counter."""
        self._grid_acc = None
        self.dwell_count = 0
        self.tong_count = {p: self.tong_init_val for p in self.prns}
        self.decided: dict[int, AcqResult] = {}

    def process_dwell(self, samples: np.ndarray, samplestamp: int = 0
                      ) -> dict[int, AcqResult]:
        """Feed one ``consumed_samples`` dwell; returns PRNs decided on
        this dwell (positive or negative). Undecided PRNs keep counting."""
        import jax.numpy as jnp

        cfg = self.cfg
        x = self._pcps._prepare_buffer(samples, 0)
        # input power = mean |x|^2 over the FFT buffer (:283-286)
        input_power = jnp.mean(x[0] * x[0] + x[1] * x[1])
        g = self._pcps._grid(x, self._pcps._dopplers) / jnp.maximum(
            input_power, jnp.finfo(jnp.float32).tiny)
        self._grid_acc = g if self._grid_acc is None else self._grid_acc + g
        self.dwell_count += 1

        p, d, eff = self._grid_acc.shape
        flat = self._grid_acc.reshape(p, -1)
        idx = np.asarray(jnp.argmax(flat, axis=-1))
        peak = np.asarray(jnp.max(flat, axis=-1))
        dopplers = np.asarray(self._pcps._dopplers)

        new: dict[int, AcqResult] = {}
        gate = self.threshold * self.dwell_count
        for row, prn in enumerate(self.prns):
            if prn in self.decided:
                continue
            if peak[row] > gate:
                self.tong_count[prn] += 1
                positive = self.tong_count[prn] >= self.tong_max_val
            else:
                self.tong_count[prn] -= 1
                positive = False
            negative = (self.tong_count[prn] <= 0
                        or self.dwell_count >= self.tong_max_dwells) \
                and not positive
            if positive or negative:
                res = self._pcps._make_result(
                    prn, positive, peak[row], gate, idx[row] % eff,
                    dopplers[idx[row] // eff], cfg.doppler_step, samplestamp)
                self.decided[prn] = res
                new[prn] = res
        return new

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        """Convenience driver: feed consecutive dwells from a buffer until
        every PRN is decided or samples run out."""
        n = self.cfg.consumed_samples
        pos = 0
        while len(self.decided) < len(self.prns) \
                and pos + n <= len(samples) \
                and self.dwell_count < self.tong_max_dwells:
            self.process_dwell(samples[pos: pos + n],
                               samplestamp + pos)
            pos += n
        return dict(self.decided)
