"""Bring-up check of the receiver on one GPU: ``python chip_smoke.py``.

One process, four phases, each printing its own lines. A failed check
raises, so the run ends with a non-zero exit code and prints no result.

- ``device``: the default JAX device is a GPU (there is no CPU fallback);
  prints the JAX version, the device kind and ``nvidia-smi``'s card name
  and power limit.
- ``acq``: the PCPS magnitude grid at cold-start widths -- GPS L1 C/A at
  4 Msps (32 PRNs x 40 Dopplers x 4000 samples, and the 8000-sample
  bit-transition layout) and GPS L5 at 12 Msps (8 PRNs x 12000) --
  against the float64 NumPy reference, with its time per grid.
- ``track``: one 1 s fast-engine superblock (12 channels, K=20, G=5,
  4 Msps, int8 ring) on the GPU against the same program on the host
  CPU, and the segsum correlator against the bank correlator on the GPU,
  with each correlator's time per superblock.
- ``e2e``: the command-line receiver (``gnss_sdr_tpu.__main__.main``,
  in-process) over a 10 s, 4 Msps GPS L1 C/A scene of every visible
  satellite of a 32-PRN constellation: 12 channels, all 32 PRNs searched,
  AGNSS ephemeris. It must reach fast mode and print at least 5 fixes
  whose mean 3D error is under 5 m.

The last line of standard output is ``{"ok": true, "device": {...}}``,
printed only when every phase passed.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np

FS = 4.0e6
N_CHANNELS = 12
#: max |grid - ref| / max(ref): float32 transforms of ~1e4 points
GRID_TOL = 1e-4
#: bank-vs-segsum bounds of tests/test_fast_engine.py: converged Doppler,
#: group prompt magnitude, and code phase (0.02 samples = 1.5 m at 4 Msps)
DOPPLER_TOL_HZ = 1.0
PROMPT_TOL = 0.02
CODE_PHASE_TOL = 0.02
#: the reference's static accuracy bound (BASELINE.md)
MAX_MEAN_ERR_M = 5.0
MIN_FIXES = 5


class PhaseFailed(RuntimeError):
    pass


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok: bool, phase: str, msg: str) -> None:
    if not ok:
        raise PhaseFailed(f"[{phase}] {msg}")


# ---------------------------------------------------------------------------
# acq
# ---------------------------------------------------------------------------


def acq_input(acq, seed: int, noise_sigma: float = 1.0):
    """One dwell holding every PRN of ``acq`` at unit amplitude, each at
    its own integer delay and on-grid Doppler, plus complex noise.
    Returns (samples, {prn: (doppler_bin, delay)})."""
    cfg = acq.cfg
    rng = np.random.default_rng(seed)
    n = cfg.consumed_samples
    spc = cfg.samples_per_code
    dopplers = cfg.doppler_grid().astype(np.float64)
    t = np.arange(n, dtype=np.float64)
    x = noise_sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    truth = {}
    code_time = np.fft.ifft(np.conj(
        np.asarray(acq._code_fft_re) + 1j * np.asarray(acq._code_fft_im)),
        axis=-1)
    for row, prn in enumerate(acq.prns):
        # the engine's replica layout holds one coherent interval
        start = cfg.fft_size // 2 if cfg.bit_transition_flag else 0
        code = code_time[row, start:start + cfg.coherent_samples]
        d_bin = int(rng.integers(1, len(dopplers) - 1))
        delay = int(rng.integers(0, spc))
        periodic = np.tile(code, n // code.shape[0] + 2)
        sig = np.roll(periodic, delay)[:n]
        x = x + sig * np.exp(2j * np.pi * dopplers[d_bin] * t / cfg.fs)
        truth[prn] = (d_bin, delay)
    return x.astype(np.complex64), truth


def compare_grids(got: np.ndarray, ref: np.ndarray) -> dict:
    """Error of a [P, D, N] device grid against its reference: the
    largest deviation relative to the reference's peak, and the PRN rows
    whose argmax cell moved."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise PhaseFailed(f"grid shape {got.shape} != reference {ref.shape}")
    p = got.shape[0]
    moved = [i for i, (a, b) in enumerate(zip(
        np.argmax(got.reshape(p, -1), axis=1),
        np.argmax(ref.reshape(p, -1), axis=1))) if a != b]
    return {"rel_err": float(np.max(np.abs(got - ref)) / np.max(ref)),
            "argmax_moved": moved,
            "finite": bool(np.all(np.isfinite(got)))}


def grid_ok(stats: dict) -> bool:
    return (stats["finite"] and stats["rel_err"] <= GRID_TOL
            and not stats["argmax_moved"])


def time_call(fn, reps: int) -> tuple[object, float, float]:
    """(result, first-call seconds incl. compilation, steady seconds per
    call). Every call ends in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return out, first, (time.perf_counter() - t0) / reps


def acq_case(name: str, acq, seed: int, reps: int = 20) -> dict:
    """Device grid vs float64 reference for one engine configuration."""
    from gnss_sdr_tpu.acquisition.pcps import magnitude_grid_reference

    x, truth = acq_input(acq, seed)
    buf = acq._prepare_buffer(x, 0)
    grid, first, per = time_call(lambda: acq._grid(buf, acq._dopplers), reps)
    xin = np.asarray(buf[0]) + 1j * np.asarray(buf[1])
    code_fft = np.asarray(acq._code_fft_re) + 1j * np.asarray(
        acq._code_fft_im)
    ref = magnitude_grid_reference(xin, code_fft, np.asarray(acq._dopplers),
                                   acq.cfg.fs, acq._offset, acq._eff)
    stats = compare_grids(np.asarray(grid), ref)
    # the peak must sit on the injected (Doppler, delay) of every PRN
    p, d, eff = ref.shape
    flat = np.argmax(ref.reshape(p, -1), axis=1)
    stats["truth_missed"] = [
        prn for row, prn in enumerate(acq.prns)
        if (flat[row] // eff, flat[row] % eff % acq.cfg.samples_per_code)
        != truth[prn]]
    stats.update(shape=[p, d, eff], first_s=first, per_grid_s=per)
    log("acq", f"{name}: P x D x N = {p} x {d} x {eff} "
        f"(fft {acq.cfg.fft_size}), rel_err {stats['rel_err']:.3e}, "
        f"argmax moved {len(stats['argmax_moved'])}/{p}, truth missed "
        f"{len(stats['truth_missed'])}/{p}, first call {first:.3f} s, "
        f"{per * 1e3:.4f} ms/grid")
    require(grid_ok(stats) and not stats["truth_missed"], "acq",
            f"{name} grid out of bounds: {stats}")
    return stats


def phase_acq() -> dict:
    from gnss_sdr_tpu.acquisition.adapters import make_acquisition

    l1 = dict(doppler_max=5000.0, doppler_step=250.0)
    return {
        "gps_l1_4000": acq_case("GPS L1 C/A 4 Msps", make_acquisition(
            "GPS_L1_CA_PCPS_Acquisition", range(1, 33), FS, **l1), 1),
        "gps_l1_8000_bit_transition": acq_case(
            "GPS L1 C/A 4 Msps bit-transition", make_acquisition(
                "GPS_L1_CA_PCPS_Acquisition", range(1, 33), FS,
                bit_transition_flag=True, **l1), 2),
        "gps_l5_12000": acq_case("GPS L5 12 Msps", make_acquisition(
            "GPS_L5i_PCPS_Acquisition", range(1, 9), 12.0e6, **l1), 3),
    }


# ---------------------------------------------------------------------------
# track
# ---------------------------------------------------------------------------


def track_scene(n_channels: int, fs: float, seconds: float, seed: int = 5):
    """GPS L1 C/A signals of PRNs 1..n at 45 dB-Hz with known integer
    delays and Dopplers, carrier phase zero at each code start (so a
    channel started on the truth is locked from its first group)."""
    from gnss_sdr_tpu.simulate import SatelliteParams, generate_gps_l1ca

    spc = int(round(fs * 1e-3))
    sats = []
    for ch in range(n_channels):
        dop = -3300.0 + 6600.0 * ch / max(1, n_channels - 1)
        delay = float((331 * ch + 17) % spc)
        sats.append(SatelliteParams(
            prn=ch + 1, cn0_db_hz=45.0, delay_samples=delay, doppler_hz=dop,
            phase_rad=-2.0 * math.pi * dop * delay / fs))
    return sats, generate_gps_l1ca(sats, fs, seconds, seed=seed)


def compare_tracks(a: np.ndarray, b: np.ndarray, k: int) -> dict:
    """Deviation between two packed fast-engine records [B, G, C, 5K+4]
    of one superblock (layout: fast_engine ``packed``): integer period
    starts that differ, the largest code-phase (start + rem) difference,
    the largest Doppler difference and the largest relative difference of
    group prompt magnitudes, over groups both runs processed."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise PhaseFailed(f"packed shape {a.shape} != {b.shape}")
    va = a[..., 5 * k + 2] > 0.5
    vb = b[..., 5 * k + 2] > 0.5
    both = va & vb

    def group_prompt(x):
        return np.abs(np.sum(x[..., 3 * k:4 * k] + 1j * x[..., 4 * k:5 * k],
                             axis=-1))

    pa, pb = group_prompt(a)[both], group_prompt(b)[both]
    phase_a = (a[..., :k] + a[..., k:2 * k])[both]
    phase_b = (b[..., :k] + b[..., k:2 * k])[both]
    return {
        "valid_equal": bool(np.array_equal(va, vb)),
        "groups": int(both.sum()),
        "starts_unequal": int(np.sum(a[..., :k][both] != b[..., :k][both])),
        "code_phase_max_diff": float(np.max(np.abs(phase_a - phase_b),
                                            initial=0.0)),
        "doppler_max_diff_hz": float(np.max(np.abs(
            a[..., 5 * k][both] - b[..., 5 * k][both]), initial=0.0)),
        "prompt_max_rel_diff": float(np.max(
            np.abs(pa / np.maximum(pb, 1e-30) - 1.0), initial=0.0)),
    }


def tracks_ok(stats: dict) -> bool:
    """Integer starts may differ only where the code phase straddles a
    sample boundary, i.e. when start + rem still agree."""
    return (stats["valid_equal"] and stats["groups"] > 0
            and stats["code_phase_max_diff"] <= CODE_PHASE_TOL
            and stats["doppler_max_diff_hz"] <= DOPPLER_TOL_HZ
            and stats["prompt_max_rel_diff"] <= PROMPT_TOL)


def run_superblock(correlator: str, device, ring8: np.ndarray, sats,
                   n_blocks: int, fs: float, reps: int) -> dict:
    """One ``n_blocks`` ring superblock of a fresh engine on ``device``
    from channels started on the truth; returns its packed record and
    times."""
    import jax
    import jax.numpy as jnp

    from gnss_sdr_tpu.codes import gps_l1ca_code
    from gnss_sdr_tpu.tracking import TrackingConfig
    from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine

    cfg = TrackingConfig(fs=fs, extend_correlation_symbols=20,
                         pll_bw_narrow_hz=5.0, dll_bw_narrow_hz=0.75)
    with jax.default_device(device):
        engine = FastTrackingEngine(cfg, len(sats), groups_per_block=5,
                                    correlator=correlator)
        codes = jnp.asarray(np.stack([
            np.asarray(gps_l1ca_code(s.prn), np.float32) for s in sats]))
        tables = engine._get_bank(codes) if correlator == "bank" else codes
        ring = jax.device_put(ring8, device)

        def fresh_state():
            st = engine.init_state()
            for ch, s in enumerate(sats):
                st = engine.start_channel(st, ch, s.doppler_hz,
                                          int(s.delay_samples))
            return st

        state = fresh_state()
        t0 = time.perf_counter()
        state, out = engine._superblock_ring_i8(
            state, ring, jnp.int32(0), n_blocks, tables)
        packed = np.asarray(out["packed"])
        first = time.perf_counter() - t0
        # steady state: the same program again (the donated state chains;
        # the work per call does not depend on its values)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, out = engine._superblock_ring_i8(
                state, ring, jnp.int32(0), n_blocks, tables)
        jax.block_until_ready(out)
        per = (time.perf_counter() - t0) / reps
    return {"packed": packed, "k": engine.k, "first_s": first,
            "per_superblock_s": per,
            "samples": n_blocks * engine.block_samples}


def truth_errors(packed: np.ndarray, k: int, sats) -> dict:
    """Final-group Doppler error against the scene and lost channels."""
    last = packed[-1, -1]
    dopp = last[:, 5 * k]
    return {"max_doppler_err_hz": float(np.max(np.abs(
        dopp - np.array([s.doppler_hz for s in sats])))),
        "lost": int(np.sum(packed[..., 5 * k + 3].max(axis=(0, 1)) > 0.5))}


def phase_track(n_blocks: int = 10, reps: int = 5) -> dict:
    import jax

    from gnss_sdr_tpu.receiver.production import quantize_i8

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    block = 5 * 20 * int(round(FS * 1e-3))
    seconds = (n_blocks + 1) * block / FS
    sats, x = track_scene(N_CHANNELS, FS, seconds)
    ring8 = np.stack(quantize_i8(x))
    runs = {
        "bank_gpu": run_superblock("bank", gpu, ring8, sats, n_blocks, FS,
                                   reps),
        "bank_cpu": run_superblock("bank", cpu, ring8, sats, n_blocks, FS, 1),
        "segsum_gpu": run_superblock("segsum", gpu, ring8, sats, n_blocks,
                                     FS, reps),
    }
    k = runs["bank_gpu"]["k"]
    for name, r in runs.items():
        log("track", f"{name}: {r['samples']} samples per superblock, "
            f"first call {r['first_s']:.3f} s, "
            f"{r['per_superblock_s'] * 1e3:.3f} ms/superblock "
            f"({r['samples'] / r['per_superblock_s'] / 1e6:.2f} Msamples/s)")
    truth = truth_errors(runs["bank_gpu"]["packed"], k, sats)
    log("track", f"bank_gpu vs scene truth: {truth}")
    require(truth["lost"] == 0 and truth["max_doppler_err_hz"] < 5.0,
            "track", f"channels did not hold lock on the scene: {truth}")
    result = {"truth": truth}
    for name, (a, b) in {
            "gpu_vs_cpu": ("bank_gpu", "bank_cpu"),
            "segsum_vs_bank": ("segsum_gpu", "bank_gpu")}.items():
        stats = compare_tracks(runs[a]["packed"], runs[b]["packed"], k)
        log("track", f"{name}: {stats}")
        require(tracks_ok(stats), "track", f"{name} out of bounds")
        result[name] = stats
    result.update({name: {"per_superblock_s": r["per_superblock_s"],
                          "first_s": r["first_s"]}
                   for name, r in runs.items()})
    return result


# ---------------------------------------------------------------------------
# e2e
# ---------------------------------------------------------------------------

E2E_CONF = """
GNSS-SDR.internal_fs_sps={fs:d}
GNSS-SDR.AGNSS_gps_ephemeris_xml={agnss}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=gr_complex
Channels_1C.count={channels:d}
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
"""


def run_cli_scene(workdir: str, fs: float, seconds: float, channels: int,
                  n_prns: int = 32, seed: int = 31) -> dict:
    """Write a scene capture, its AGNSS XML and an INI into ``workdir``,
    run the command-line receiver on it in-process and score its fixes
    against the scene's receiver position."""
    import gnss_sdr_tpu.__main__ as cli
    from gnss_sdr_tpu.receiver.assistance import save_ephemeris_xml
    from gnss_sdr_tpu.simulate.rf_scene import generate_scene
    from gnss_sdr_tpu.simulate.scenario import (make_constellation,
                                                rx_position, visible_sats)

    toe = 7200.0
    bits_start = toe + 598 * 6.0
    t_start = bits_start + 4.5
    rx = rx_position()
    ephs = make_constellation(range(1, n_prns + 1), toe_s=toe)
    prns = visible_sats(ephs, rx, t_start)
    t0 = time.perf_counter()
    x = generate_scene(ephs, prns, rx, t_start, seconds, fs,
                       bits_start_tow_s=bits_start, n_subframes=4,
                       cn0_db_hz=48.0, seed=seed)
    capture = os.path.join(workdir, "scene.dat")
    x.astype(np.complex64).tofile(capture)
    scene_s = time.perf_counter() - t0
    agnss = save_ephemeris_xml(ephs, os.path.join(workdir, "gps_eph.xml"))
    conf = os.path.join(workdir, "rx.conf")
    with open(conf, "w") as fh:
        fh.write(textwrap.dedent(E2E_CONF.format(
            fs=int(fs), agnss=agnss, capture=capture, channels=channels)))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-c", conf])
    wall = time.perf_counter() - t0
    rec = cli.last_receiver
    fixes = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("$GPGGA")]
    errs = [float(np.linalg.norm(s.pos_ecef - rx)) for s in rec.solutions]
    timings = getattr(rec, "timings", {})
    return {
        "rc": rc, "visible_prns": list(prns), "capture_s": seconds,
        "scene_gen_s": scene_s, "fixes": len(fixes),
        "mean_err_m": float(np.mean(errs)) if errs else float("nan"),
        "max_err_m": float(np.max(errs)) if errs else float("nan"),
        "in_fast_mode": bool(getattr(rec, "in_fast_mode", False)),
        "phase_a_s": timings.get("phase_a_s"),
        "phase_a_samples": timings.get("phase_a_samples"),
        "phase_b_s": timings.get("phase_b_s"),
        "phase_b_samples": timings.get("phase_b_samples"),
        "wall_s": wall, "realtime_factor": seconds / wall,
        "first_fix": fixes[0] if fixes else None,
    }


def e2e_ok(r: dict) -> bool:
    return (r["rc"] == 0 and r["in_fast_mode"] and r["fixes"] >= MIN_FIXES
            and r["mean_err_m"] < MAX_MEAN_ERR_M)


def phase_e2e(seconds: float = 10.0) -> dict:
    with tempfile.TemporaryDirectory() as td:
        r = run_cli_scene(td, FS, seconds, N_CHANNELS)
    for key, val in r.items():
        log("e2e", f"{key}: {val}")
    require(e2e_ok(r), "e2e", "receiver run out of bounds")
    return r


# ---------------------------------------------------------------------------
# device + driver
# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    # the track phase also runs on the host CPU backend
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    from gnss_sdr_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: the default JAX device is {dev.platform!r}, "
              "not a GPU; nothing was run", file=sys.stderr)
        return 1
    log("device", f"jax {jax.__version__}, {dev.device_kind}, "
        f"{len(jax.devices())} device(s), compile cache "
        f"{enable_compile_cache()}")
    log("device", f"nvidia-smi: {nvidia_smi()}")
    phase_acq()
    phase_track()
    phase_e2e()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
