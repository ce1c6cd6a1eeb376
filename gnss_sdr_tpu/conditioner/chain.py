"""Signal conditioner container: DataTypeAdapter -> InputFilter ->
Resampler between the signal source and the receiver.

Counterpart of the reference's SignalConditioner block
(/root/reference/src/algorithms/conditioner/adapters/
signal_conditioner.cc:37-85 connects the three roles in series) with the
input-filter adapters (fir_filter.cc, freq_xlating_fir_filter.cc,
pulse_blanking_filter.cc, notch_filter.cc) and resamplers
(direct_resampler_conditioner.cc, mmse_resampler_conditioner.cc).

Array-program shape: the whole chain is one pure function over the capture
(or a carried-tail streaming step), so XLA fuses translate+filter+
decimate into a single device program instead of three GNU Radio blocks
with ring buffers.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu.conditioner.fir import (design_lowpass_taps, fir_filter,
                                          freq_xlating_fir_filter)

SUPPORTED_INPUT_FILTERS = {
    "Pass_Through",
    "Fir_Filter",
    "Freq_Xlating_Fir_Filter",
    "Pulse_Blanking_Filter",
    "Notch_Filter",
    "Notch_Filter_Lite",
}
SUPPORTED_RESAMPLERS = {
    "Pass_Through",
    "Direct_Resampler",
    "Mmse_Resampler",
}
#: data-type adaptation happens in the source's native ingest
#: (sources/unpack.py converts ishort/ibyte/cbyte to planar complex), so
#: the adapter names are accepted as documentation of the input format
SUPPORTED_ADAPTERS = {
    "Pass_Through",
    "Ishort_To_Complex",
    "Ibyte_To_Complex",
    "Byte_To_Short",
    "Ishort_To_Cshort",
    "Ibyte_To_Cshort",
    "Ibyte_To_Cbyte",
}


class SignalConditionerChain:
    """Configured conditioner pipeline; ``fs_out`` is the rate delivered
    to the receiver (must equal ``GNSS-SDR.internal_fs_sps``)."""

    def __init__(self, fs_in: float, input_filter: str = "Pass_Through",
                 if_freq_hz: float = 0.0, decimation: int = 1,
                 ntaps: int = 65, cutoff_hz: float | None = None,
                 transition_hz: float | None = None,
                 resampler: str = "Pass_Through",
                 resample_fs_out: float | None = None,
                 pb_threshold_sigma: float = 4.0,
                 notch_excision: float = 8.0):
        if input_filter not in SUPPORTED_INPUT_FILTERS:
            raise ValueError(
                f"InputFilter.implementation={input_filter!r} is not "
                f"available; supported: {sorted(SUPPORTED_INPUT_FILTERS)}")
        if resampler not in SUPPORTED_RESAMPLERS:
            raise ValueError(
                f"Resampler.implementation={resampler!r} is not "
                f"available; supported: {sorted(SUPPORTED_RESAMPLERS)}")
        self.fs_in = fs_in
        self.input_filter = input_filter
        self.if_freq_hz = if_freq_hz
        self.decimation = max(1, int(decimation))
        self.resampler = resampler
        fs_mid = fs_in / self.decimation \
            if input_filter in ("Fir_Filter", "Freq_Xlating_Fir_Filter") \
            else fs_in
        self.fs_mid = fs_mid
        self.fs_out = float(resample_fs_out or fs_mid) \
            if resampler != "Pass_Through" else fs_mid
        self.pb_threshold_sigma = pb_threshold_sigma
        self.notch_excision = notch_excision
        self.taps = None
        if input_filter in ("Fir_Filter", "Freq_Xlating_Fir_Filter"):
            cut = cutoff_hz if cutoff_hz is not None else 0.45 * fs_mid
            trans = transition_hz if transition_hz is not None \
                else 0.1 * fs_mid
            self.taps = design_lowpass_taps(fs_in, cut, trans, ntaps)
        # streaming state: carried tail (ntaps-1 raw samples) + absolute
        # sample counter for the translation NCO's phase continuity
        self._tail: np.ndarray | None = None
        self._n_in: int = 0

    # -- one-shot over a full capture -------------------------------------
    def apply(self, x: np.ndarray) -> np.ndarray:
        """Condition a complex capture; returns complex64 at fs_out."""
        import jax.numpy as jnp

        xr = jnp.asarray(np.ascontiguousarray(x.real, np.float32))
        xi = jnp.asarray(np.ascontiguousarray(x.imag, np.float32))
        y = self._apply_planar((xr, xi), n0=0)
        out = np.asarray(y[0]) + 1j * np.asarray(y[1])
        return out.astype(np.complex64)

    def _apply_planar(self, x, n0: int):
        import jax.numpy as jnp

        if self.input_filter == "Freq_Xlating_Fir_Filter":
            # phase-continuous translation across stream chunks: the NCO
            # argument is the absolute input-sample index, accumulated in
            # float64 modulo 2*pi on the host (a float32 index loses
            # integer precision past 2^24 samples ~ seconds of capture)
            n = np.arange(int(x[0].shape[0]), dtype=np.float64) + n0
            ph = np.mod((-2.0 * np.pi * self.if_freq_hz / self.fs_in) * n,
                        2.0 * np.pi)
            c = jnp.asarray(np.cos(ph).astype(np.float32))
            s = jnp.asarray(np.sin(ph).astype(np.float32))
            x = (x[0] * c - x[1] * s, x[0] * s + x[1] * c)
            x = fir_filter(x, self.taps, self.decimation)
        elif self.input_filter == "Fir_Filter":
            x = fir_filter(x, self.taps, self.decimation)
        elif self.input_filter == "Pulse_Blanking_Filter":
            from gnss_sdr_tpu.conditioner.interference import pulse_blanking

            x = pulse_blanking(x, self.pb_threshold_sigma)
        elif self.input_filter in ("Notch_Filter", "Notch_Filter_Lite"):
            from gnss_sdr_tpu.conditioner.interference import (
                notch_filter_block)

            x = notch_filter_block(x, self.notch_excision)
        if self.resampler == "Mmse_Resampler":
            from gnss_sdr_tpu.conditioner.resampler import mmse_resample

            x = mmse_resample(x, self.fs_mid, self.fs_out)
        elif self.resampler == "Direct_Resampler":
            from gnss_sdr_tpu.conditioner.resampler import (
                direct_resample_indices)

            idx = direct_resample_indices(
                int(x[0].shape[0]), self.fs_mid, self.fs_out)
            x = (x[0][idx], x[1][idx])
        return x

    # -- streaming (live sources) -----------------------------------------
    def apply_stream(self, chunk: np.ndarray) -> np.ndarray:
        """Condition a stream chunk so chunked outputs concatenate to the
        one-shot :meth:`apply` result (GNU Radio history semantics,
        gnss_flowgraph ring buffers): a raw-sample tail is carried across
        calls, the buffer base is kept decimation-aligned so the
        decimator phase is global, and the translation NCO runs on
        absolute sample indices."""
        if self.resampler != "Pass_Through":
            raise NotImplementedError(
                "streaming conditioner supports filter chains only; "
                "resamplers need the one-shot apply() path")
        import jax.numpy as jnp

        d = self.decimation
        ntaps = 0 if self.taps is None else len(self.taps)
        if self._tail is None:
            self._tail = np.zeros(0, dtype=np.complex64)
            self._base = 0        # global input index of tail[0], % d == 0
            self._next_k = 0      # next output (decimated) index to emit
        x = np.concatenate([self._tail, chunk.astype(np.complex64)])
        xr = jnp.asarray(np.ascontiguousarray(x.real, np.float32))
        xi = jnp.asarray(np.ascontiguousarray(x.imag, np.float32))
        y = self._apply_planar((xr, xi), n0=self._base)
        yr, yi = np.asarray(y[0]), np.asarray(y[1])
        # local output k <-> global input self._base + k*d
        k0 = self._next_k - self._base // d
        out = (yr[k0:] + 1j * yi[k0:]).astype(np.complex64)
        self._next_k += len(out)
        self._n_in = self._base + len(x)
        # keep >= ntaps-1 raw samples of history, base decimation-aligned
        keep_from_global = max(self._n_in - max(ntaps - 1, 0), 0) // d * d
        self._tail = x[keep_from_global - self._base:]
        self._base = keep_from_global
        return out
