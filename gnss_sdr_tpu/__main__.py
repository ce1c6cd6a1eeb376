"""Command-line receiver: ``python -m gnss_sdr_tpu --config_file=rx.conf``.

Counterpart of the reference's main binary
(/root/reference/src/main/main.cc:66-204): loads an INI configuration,
applies CLI overrides (the gflags layer, gnss_sdr_flags.cc — same flag
names for the common knobs), assembles the receiver via the
implementation-name factory, streams the configured signal source, and
prints fixes as NMEA. Exit code 42 requests a restart (harness contract,
gnss-sdr-harness.sh).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gnss_sdr_tpu")
    p.add_argument("--config_file", "-c", required=True,
                   help="INI configuration (reference dialect)")
    p.add_argument("--signal_source", "-s", default=None,
                   help="override SignalSource.filename")
    # gflags-parity overrides (gnss_sdr_flags.cc)
    p.add_argument("--doppler_max", type=float, default=None)
    p.add_argument("--doppler_step", type=float, default=None)
    p.add_argument("--pll_bw_hz", type=float, default=None)
    p.add_argument("--dll_bw_hz", type=float, default=None)
    p.add_argument("--cn0_min", type=float, default=None)
    p.add_argument("--max_lock_fail", type=int, default=None)
    p.add_argument("--kml", default=None, help="write KML track here")
    p.add_argument("--telecommand_port", type=int, default=0,
                   help="enable the TCP telecommand server on this port")
    return p


#: last receiver built by :func:`main` (test/introspection hook)
last_receiver = None


def main(argv=None) -> int:
    global last_receiver
    args = build_parser().parse_args(argv)

    from gnss_sdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from gnss_sdr_tpu.config import FileConfiguration
    from gnss_sdr_tpu.monitor import KmlWriter, nmea_gga
    from gnss_sdr_tpu.receiver.factory import (_configured_suffixes,
                                               make_receiver,
                                               make_signal_conditioner,
                                               make_signal_source)
    from gnss_sdr_tpu.receiver.telecommand import TelecommandServer

    config = FileConfiguration(args.config_file)
    # gflags-style overrides apply to EVERY configured signal group, as
    # the reference's flags do (gnss_sdr_flags.cc:25-66 are global knobs)
    suffixes = _configured_suffixes(config) or ["1C"]
    overrides = {"SignalSource.filename": args.signal_source}
    for sx in suffixes:
        overrides.update({
            f"Acquisition_{sx}.doppler_max": args.doppler_max,
            f"Acquisition_{sx}.doppler_step": args.doppler_step,
            f"Tracking_{sx}.pll_bw_hz": args.pll_bw_hz,
            f"Tracking_{sx}.dll_bw_hz": args.dll_bw_hz,
        })
    config.apply_overrides(
        {k: str(v) for k, v in overrides.items() if v is not None})

    source = make_signal_source(config)
    if source is None:
        print("ERROR: SignalSource.implementation missing", file=sys.stderr)
        return 2
    conditioner = make_signal_conditioner(config)
    bounded = getattr(source, "n_samples", None)
    # unbounded (live) sources stream block-by-block through the scan
    # pipeline; bounded captures run the production fast path end-to-end
    receiver = make_receiver(
        config, engine=None if bounded else "scan")
    last_receiver = receiver

    server = None
    if args.telecommand_port:
        server = TelecommandServer(receiver.apply_command,
                                   port=args.telecommand_port)
        server.start()
        print(f"telecommand server on port {server.port}", file=sys.stderr)

    kml = KmlWriter(args.kml) if args.kml else None
    pos = 0
    try:
        if bounded and hasattr(receiver, "run"):
            samples = source.read(0, bounded)
            if conditioner is not None:
                samples = conditioner.apply(samples)
            receiver.run(samples)
            pos = len(samples)
            for sol in receiver.solutions:
                print(nmea_gga(sol.lat_rad, sol.lon_rad, sol.height_m,
                               sol.n_sats, sol.hdop), end="")
                if kml:
                    kml.add_fix(sol.lat_rad, sol.lon_rad, sol.height_m)
        else:
            block = receiver.block_samples
            overlap = receiver.overlap
            buf = np.zeros(0, dtype=np.complex64)
            raw_pos = 0
            raw_chunk = int(getattr(source, "fs", 0) or 4e6)  # ~1 s reads
            exhausted = False
            while True:
                while len(buf) < block + overlap and not exhausted:
                    if bounded:
                        n = min(raw_chunk, bounded - raw_pos)
                        if n <= 0:
                            exhausted = True
                            break
                        fresh = source.read(raw_pos, n)
                        raw_pos += n
                    else:
                        fresh = source.read_block(raw_chunk)
                    if conditioner is not None:
                        fresh = conditioner.apply_stream(fresh)
                    buf = np.concatenate([buf, fresh])
                if len(buf) < block + overlap:
                    break
                for sol in receiver.process_block(buf[:block + overlap]):
                    print(nmea_gga(sol.lat_rad, sol.lon_rad, sol.height_m,
                                   sol.n_sats, sol.hdop), end="")
                    if kml:
                        kml.add_fix(sol.lat_rad, sol.lon_rad, sol.height_m)
                buf = buf[block:]
                pos += block
    except KeyboardInterrupt:
        pass
    finally:
        if kml:
            kml.close()
        if server:
            server.stop()
        mons = getattr(receiver, "monitors", None) or getattr(
            getattr(receiver, "receiver", None), "monitors", None)
        if mons is not None:
            mons.close()
        if config.property("PVT.rinex_output_enabled", False) \
                and hasattr(receiver, "write_rinex"):
            name = config.property("PVT.rinex_name", "GSDR")
            paths = receiver.write_rinex(f"{name}.obs", f"{name}.nav")
            print(f"RINEX written: {paths[0]} {paths[1]}", file=sys.stderr)
    fast = getattr(receiver, "in_fast_mode", None)
    engine = "scan" if fast is None else f"production fast_mode={fast}"
    print(f"processed {pos} samples, {len(receiver.solutions)} fixes "
          f"[engine={engine}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
