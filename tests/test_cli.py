"""CLI entry point smoke tests (main.cc:66-204 analogue): config load,
gflags-style overrides, streaming loop, NMEA/KML sinks."""

import os
import subprocess
import sys
import textwrap

import numpy as np

from gnss_sdr_tpu.__main__ import build_parser, main

CONF = """
GNSS-SDR.internal_fs_sps=2500000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={filename}
SignalSource.item_type=gr_complex
Channels_1C.count=4
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.doppler_max=4000
Acquisition_1C.doppler_step=250
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
"""


def _write_fixture(tmp_path, seconds=0.25, fs=2.5e6):
    rng = np.random.default_rng(7)
    n = int(seconds * fs)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    cap = tmp_path / "cap.dat"
    x.tofile(cap)
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(filename=cap)))
    return conf


def test_parser_flags():
    args = build_parser().parse_args(
        ["-c", "rx.conf", "--doppler_max", "6000", "--pll_bw_hz", "25"])
    assert args.config_file == "rx.conf"
    assert args.doppler_max == 6000.0 and args.pll_bw_hz == 25.0


def test_cli_runs_noise_capture(tmp_path, capsys):
    conf = _write_fixture(tmp_path)
    kml = tmp_path / "track.kml"
    rc = main(["-c", str(conf), "--doppler_max", "3000", "--kml", str(kml)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "processed" in err
    # KML closed even with zero fixes
    assert kml.exists() and b"</kml>" in kml.read_bytes()


def test_cli_runs_without_protobuf(tmp_path):
    """protobuf is only needed once a UDP monitor is configured."""
    conf = _write_fixture(tmp_path)
    code = ("import sys; sys.modules['google.protobuf'] = None; "
            "from gnss_sdr_tpu.__main__ import main; "
            f"sys.exit(main(['-c', {str(conf)!r}]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "processed" in proc.stderr


def test_udp_monitor_without_protobuf_says_so():
    code = ("import sys; sys.modules['google.protobuf'] = None\n"
            "try:\n"
            "    from gnss_sdr_tpu.monitor import UdpMonitor\n"
            "except ImportError as exc:\n"
            "    print(exc)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert "'protobuf' package" in proc.stdout, proc.stderr[-2000:]


def test_cli_missing_source_is_an_error(tmp_path):
    conf = tmp_path / "bad.conf"
    conf.write_text("GNSS-SDR.internal_fs_sps=2500000\n")
    assert main(["-c", str(conf)]) == 2


def test_cli_production_fast_mode_fix(tmp_path, capsys):
    """`python -m gnss_sdr_tpu -c rx.conf` over a real scene runs the
    production fast path end-to-end: handoff to the fast engine and NMEA
    fixes out — the config surface IS the real-time path
    (gnss_block_factory.cc:637, main.cc:66-204)."""
    import gnss_sdr_tpu.__main__ as cli
    from gnss_sdr_tpu.receiver.assistance import save_ephemeris_xml
    from gnss_sdr_tpu.simulate.rf_scene import generate_scene
    from gnss_sdr_tpu.simulate.scenario import (make_constellation,
                                                rx_position, visible_sats)

    fs = 2.5e6
    toe = 7200.0
    bits_start = 7200.0 + 598 * 6.0
    t_start = bits_start + 4.5
    rx = rx_position()
    ephs = make_constellation(range(1, 13), toe_s=toe)
    prns = visible_sats(ephs, rx, t_start)[:5]
    x = generate_scene(ephs, prns, rx, t_start, 8.4, fs,
                       bits_start_tow_s=bits_start, n_subframes=4,
                       cn0_db_hz=48.0, seed=31)
    cap = tmp_path / "scene.dat"
    x.astype(np.complex64).tofile(cap)
    agnss = tmp_path / "gps_ephemeris.xml"
    save_ephemeris_xml({p: ephs[p] for p in prns}, agnss)
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(filename=cap)) + textwrap.dedent(f"""
        GNSS-SDR.AGNSS_gps_ephemeris_xml={agnss}
        Channels_1C.count=5
        Channels_1C.satellites={",".join(str(p) for p in prns)}
        Tracking_1C.pull_in_time_s=0.4
        """))

    rc = main(["-c", str(conf)])
    captured = capsys.readouterr()
    assert rc == 0
    assert cli.last_receiver.in_fast_mode, \
        "CLI receiver never entered fast mode"
    assert "engine=production fast_mode=True" in captured.err
    fixes = [ln for ln in captured.out.splitlines() if ln.startswith("$GPGGA")]
    assert len(fixes) >= 5, captured.err
