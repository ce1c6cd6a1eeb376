"""GNSS software-defined receiver framework in JAX.

A from-scratch reimplementation of the capabilities of GNSS-SDR
(reference: GNSS-SDR v0.0.17 fork) built as accelerator array programs:

- The signal-processing plane (acquisition, tracking, conditioning) is a set
  of pure, ``jit``-compiled JAX array programs. Channels (satellite PRN x
  signal) are a batch axis that ``vmap``s on one chip and shards across a
  ``jax.sharding.Mesh`` on many.
- The control plane (channel state machines, satellite work queue,
  acquisition scheduling, telemetry decoding, PVT) is host-side Python that
  runs between device steps -- replacing the reference's GNU Radio
  thread-per-block flowgraph (``src/core/receiver/gnss_flowgraph.cc``) and
  pmt event queues with plain function calls.

Subpackage map (reference layer in parentheses, see SURVEY.md):

- :mod:`gnss_sdr_tpu.constants`  -- signal/system parameters (L6).
- :mod:`gnss_sdr_tpu.codes`      -- PRN replica generators (L5).
- :mod:`gnss_sdr_tpu.config`     -- INI-compatible configuration (L1).
- :mod:`gnss_sdr_tpu.sources`    -- sample ingest + format unpackers (L4 signal_source).
- :mod:`gnss_sdr_tpu.ops`        -- jax kernels: correlators, NCOs, filters, discriminators (L5).
- :mod:`gnss_sdr_tpu.acquisition`-- batched PCPS engine (L4 acquisition).
- :mod:`gnss_sdr_tpu.tracking`   -- DLL/PLL/FLL scan engine (L4 tracking).
- :mod:`gnss_sdr_tpu.telemetry`  -- nav message decoders (L4/L6).
- :mod:`gnss_sdr_tpu.observables`-- common-reception-time observables (L4).
- :mod:`gnss_sdr_tpu.pvt`        -- ephemeris eval + least-squares PVT (L7).
- :mod:`gnss_sdr_tpu.receiver`   -- control plane: FSM, scheduler, receiver loop (L1/L2).
- :mod:`gnss_sdr_tpu.simulate`   -- synthetic IF signal generator (test oracle).
- :mod:`gnss_sdr_tpu.parallel`   -- mesh/sharding helpers (multi-chip scale-out).
"""

__version__ = "0.1.0"
