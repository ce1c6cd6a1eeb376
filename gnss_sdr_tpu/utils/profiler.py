"""Device-kernel profiler — the reference's autotuner analogue.

Counterpart of ``volk_gnsssdr_profile``
(/root/reference/src/algorithms/libs/volk_gnsssdr_module/volk_gnsssdr/
apps/): times the framework's hot device programs (PCPS grids across FFT
sizes and Doppler-bin counts; tracking block programs across channel
counts; scan vs group-batched engines) and writes a per-machine JSON
profile that records the measured throughputs — the data you use to pick
block sizes, groups-per-block, and engine variants for a deployment.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _time(fn, reps: int = 3) -> float:
    import jax

    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def profile_acquisition(fft_sizes=(2046, 4000, 8000), n_doppler=41,
                        n_prn=8) -> list[dict]:
    import jax.numpy as jnp

    from gnss_sdr_tpu.acquisition.pcps import _pcps_magnitude_grid

    rng = np.random.default_rng(0)
    rows = []
    for n in fft_sizes:
        x_re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        x_im = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        cf_re = jnp.asarray(
            rng.standard_normal((n_prn, n)).astype(np.float32))
        cf_im = jnp.asarray(
            rng.standard_normal((n_prn, n)).astype(np.float32))
        dop = jnp.linspace(-5000, 5000, n_doppler, dtype=jnp.float32)
        dt = _time(lambda: _pcps_magnitude_grid(
            x_re, x_im, cf_re, cf_im, dop, jnp.float32(4e6),
            offset=0, eff=n))
        rows.append(dict(kernel="pcps_grid", fft_size=n, n_prn=n_prn,
                         n_doppler=n_doppler, seconds=dt,
                         grids_per_s=round(1.0 / dt, 2)))
    return rows


def profile_tracking(channel_counts=(4, 12), fs=2.046e6,
                     block_ms=20) -> list[dict]:
    import jax.numpy as jnp

    from gnss_sdr_tpu.codes import gps_l1ca_code
    from gnss_sdr_tpu.tracking import TrackingConfig, TrackingEngine

    rng = np.random.default_rng(1)
    rows = []
    block_samples = int(fs * block_ms * 1e-3)
    for c in channel_counts:
        cfg = TrackingConfig(fs=fs)
        eng = TrackingEngine(cfg, c, block_samples)
        n = block_samples + eng.overlap
        bre = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        bim = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        codes = jnp.asarray(np.stack(
            [np.asarray(gps_l1ca_code(1 + p % 32), np.float32)
             for p in range(c)]))
        st = eng.init_state()
        for ch in range(c):
            st = eng.start_channel(st, ch, 100.0 * ch, 13 * ch,
                                   cfg.samples_per_code)
        # the block step donates its carry: chain it through a cell
        cell = [st]

        def run():
            import jax

            s2, out = eng._block_step(cell[0], bre, bim, codes)
            cell[0] = s2
            return out

        dt = _time(run)
        rows.append(dict(kernel="tracking_scan_block", channels=c,
                         fs=fs, block_ms=block_ms, seconds=dt,
                         samples_per_s=round(block_samples / dt, 0)))
    return rows


def run_profile(path: str | None = None) -> dict:
    """Run all profiles; optionally write the JSON profile file."""
    import jax

    profile = dict(
        platform=jax.devices()[0].platform,
        device=str(jax.devices()[0]),
        acquisition=profile_acquisition(),
        tracking=profile_tracking(),
    )
    if path:
        with open(path, "w") as fh:
            json.dump(profile, fh, indent=1)
    return profile
