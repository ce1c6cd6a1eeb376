"""UDP monitor sinks with the reference's protobuf wire formats.

Counterpart of the reference's gnss_synchro_monitor / monitor_pvt_udp_sink /
nav_message_udp_sink (reference: src/core/monitor/gnss_synchro_monitor.h:41-77,
src/algorithms/PVT/libs/monitor_pvt_udp_sink.cc,
src/core/libs/nav_message_udp_sink.cc; instantiated at
gnss_flowgraph.cc:190-275). Payloads use the same protobuf schemas as the
reference (docs/protobuf/{gnss_synchro,monitor_pvt,nav_message}.proto —
re-authored field-compatible copies live in ``monitor/proto/``), so
existing listeners (e.g. gnss-sdr-monitor, the nav-listener utility)
interoperate. A JSON mode is retained for quick debugging
(``wire="json"``), mirroring the reference's
``Monitor.enable_protobuf`` toggle.
"""

from __future__ import annotations

import json
import math
import socket

try:
    from gnss_sdr_tpu.monitor.proto import (
        galileo_ephemeris_pb2, gnss_synchro_pb2, gps_ephemeris_pb2,
        monitor_pvt_pb2, nav_message_pb2)
except ImportError as exc:
    raise ImportError(
        "the UDP monitors need the 'protobuf' package: install the "
        "'monitor' extra (pip install 'gnss-sdr-tpu[monitor]') or disable "
        "the *.enable_monitor keys") from exc


def synchro_to_proto(s) -> gnss_synchro_pb2.GnssSynchro:
    """Map a core_types.GnssSynchro (or any object with those attribute
    names) onto the wire message."""
    m = gnss_synchro_pb2.GnssSynchro()
    m.system = getattr(s, "system", "") or ""
    m.signal = getattr(s, "signal", "") or ""
    m.prn = int(getattr(s, "prn", 0))
    m.channel_id = int(getattr(s, "channel_id", -1))
    m.acq_delay_samples = float(getattr(s, "acq_delay_samples", 0.0))
    m.acq_doppler_hz = float(getattr(s, "acq_doppler_hz", 0.0))
    m.acq_samplestamp_samples = int(getattr(s, "acq_samplestamp_samples", 0))
    m.acq_doppler_step = int(getattr(s, "acq_doppler_step", 0))
    m.flag_valid_acquisition = bool(getattr(s, "flag_valid_acquisition", False))
    m.fs = int(getattr(s, "fs", 0))
    m.prompt_i = float(getattr(s, "prompt_i", 0.0))
    m.prompt_q = float(getattr(s, "prompt_q", 0.0))
    m.cn0_db_hz = float(getattr(s, "cn0_db_hz", 0.0))
    m.carrier_doppler_hz = float(getattr(s, "carrier_doppler_hz", 0.0))
    m.carrier_phase_rads = float(getattr(s, "carrier_phase_rads", 0.0))
    m.code_phase_samples = float(getattr(s, "code_phase_samples", 0.0))
    m.tracking_sample_counter = int(getattr(s, "tracking_sample_counter", 0))
    m.flag_valid_symbol_output = bool(getattr(s, "flag_valid_symbol_output", False))
    m.correlation_length_ms = int(getattr(s, "correlation_length_ms", 1))
    m.flag_valid_word = bool(getattr(s, "flag_valid_word", False))
    m.tow_at_current_symbol_ms = int(getattr(s, "tow_at_current_symbol_ms", 0))
    m.pseudorange_m = float(getattr(s, "pseudorange_m", 0.0))
    m.rx_time = float(getattr(s, "rx_time", 0.0))
    m.flag_valid_pseudorange = bool(getattr(s, "flag_valid_pseudorange", False))
    m.interp_tow_ms = float(getattr(s, "interp_tow_ms", 0.0))
    m.flag_PLL_180_deg_phase_locked = bool(
        getattr(s, "flag_pll_180_deg_phase_locked", False))
    m.evm = float(getattr(s, "evm", 0.0))
    return m


def decode_observables(payload: bytes) -> list[gnss_synchro_pb2.GnssSynchro]:
    obs = gnss_synchro_pb2.Observables.FromString(payload)
    return list(obs.observable)


def decode_monitor_pvt(payload: bytes) -> monitor_pvt_pb2.MonitorPvt:
    return monitor_pvt_pb2.MonitorPvt.FromString(payload)


def decode_nav_message(payload: bytes) -> nav_message_pb2.navMsg:
    return nav_message_pb2.navMsg.FromString(payload)


def decode_ephemeris(payload: bytes):
    """Decode one ephemeris-monitor datagram. The reference's protobuf
    mode prefixes the message with a one-byte system tag ('G' GPS /
    'E' Galileo, monitor_ephemeris_udp_sink.cc:42-57)."""
    tag, body = payload[:1], payload[1:]
    if tag == b"G":
        return gps_ephemeris_pb2.GpsEphemeris.FromString(body)
    if tag == b"E":
        return galileo_ephemeris_pb2.GalileoEphemeris.FromString(body)
    raise ValueError(f"unknown ephemeris system tag {tag!r}")


def _fill_kepler(m, eph) -> None:
    """Common Kepler + clock fields (pvt.ephemeris.GpsEphemeris names →
    reference wire names)."""
    m.PRN = int(eph.prn)
    m.M_0 = float(eph.m0_rad)
    m.delta_n = float(eph.delta_n_rad_s)
    m.ecc = float(eph.ecc)
    m.sqrtA = float(eph.sqrt_a)
    m.OMEGA_0 = float(eph.omega0_rad)
    m.i_0 = float(eph.i0_rad)
    m.omega = float(eph.omega_rad)
    m.OMEGAdot = float(eph.omega_dot_rad_s)
    m.idot = float(eph.idot_rad_s)
    m.Cuc = float(eph.cuc_rad)
    m.Cus = float(eph.cus_rad)
    m.Crc = float(eph.crc_m)
    m.Crs = float(eph.crs_m)
    m.Cic = float(eph.cic_rad)
    m.Cis = float(eph.cis_rad)
    m.toe = int(eph.toe_s)
    m.toc = int(eph.toc_s)
    m.af0 = float(eph.af0)
    m.af1 = float(eph.af1)
    m.af2 = float(eph.af2)
    m.WN = int(eph.week_number)


class UdpMonitor:
    """Streams tracking/observables rows and PVT solutions over UDP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234,
                 wire: str = "protobuf"):
        if wire not in ("protobuf", "json"):
            raise ValueError("wire must be 'protobuf' or 'json'")
        self.address = (host, port)
        self.wire = wire
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    # -- tracking periods / observables epochs ------------------------------

    def send_observables(self, periods) -> int:
        """Stream per-period tracking rows. Accepts core GnssSynchro
        objects or tracking-engine period records."""
        if self.wire == "protobuf":
            obs = gnss_synchro_pb2.Observables()
            for p in periods:
                if hasattr(p, "carrier_doppler_hz") and hasattr(p, "prn"):
                    if hasattr(p, "prompt"):  # tracking period record
                        m = obs.observable.add()
                        m.prn = int(p.prn)
                        m.channel_id = int(getattr(p, "channel", -1))
                        m.prompt_i = float(p.prompt.real)
                        m.prompt_q = float(p.prompt.imag)
                        m.cn0_db_hz = float(p.cn0_db_hz)
                        m.carrier_doppler_hz = float(p.carrier_doppler_hz)
                        m.carrier_phase_rads = float(p.acc_carrier_phase_rad)
                        m.tracking_sample_counter = int(p.sample_start)
                        m.flag_valid_symbol_output = True
                        m.evm = float(getattr(p, "evm", 0.0))
                    else:
                        obs.observable.append(synchro_to_proto(p))
            payload = obs.SerializeToString()
        else:
            rows = [{
                "PRN": p.prn,
                "Channel_ID": getattr(p, "channel",
                                      getattr(p, "channel_id", -1)),
                "Prompt_I": p.prompt.real if hasattr(p, "prompt")
                else getattr(p, "prompt_i", 0.0),
                "Prompt_Q": p.prompt.imag if hasattr(p, "prompt")
                else getattr(p, "prompt_q", 0.0),
                "CN0_dB_hz": p.cn0_db_hz,
                "Carrier_Doppler_hz": p.carrier_doppler_hz,
                "Carrier_phase_rads": getattr(p, "acc_carrier_phase_rad",
                                              getattr(p, "carrier_phase_rads", 0.0)),
                "Tracking_sample_counter": getattr(p, "sample_start",
                                                   getattr(p, "tracking_sample_counter", 0)),
                "EVM": getattr(p, "evm", 0.0),
            } for p in periods]
            payload = json.dumps(rows).encode()
        self._sock.sendto(payload, self.address)
        return len(payload)

    # -- PVT -----------------------------------------------------------------

    def send_pvt(self, sol) -> int:
        """Stream one PVT solution (MonitorPvt wire message)."""
        if self.wire == "protobuf":
            m = monitor_pvt_pb2.MonitorPvt()
            m.rx_time = float(getattr(sol, "rx_time_s", 0.0) or 0.0)
            m.user_clk_offset = float(sol.clock_bias_s)
            m.pos_x, m.pos_y, m.pos_z = (float(v) for v in sol.pos_ecef)
            if sol.vel_ecef is not None:
                m.vel_x, m.vel_y, m.vel_z = (float(v) for v in sol.vel_ecef)
            m.latitude = math.degrees(sol.lat_rad)
            m.longitude = math.degrees(sol.lon_rad)
            m.height = float(sol.height_m)
            m.valid_sats = int(sol.n_sats)
            m.gdop = float(sol.gdop)
            m.pdop = float(sol.pdop)
            m.hdop = float(sol.hdop)
            m.vdop = float(sol.vdop)
            payload = m.SerializeToString()
        else:
            payload = json.dumps({
                "lat": sol.lat_rad, "lon": sol.lon_rad,
                "height": sol.height_m,
                "x": sol.pos_ecef[0], "y": sol.pos_ecef[1],
                "z": sol.pos_ecef[2],
                "vx": None if sol.vel_ecef is None else sol.vel_ecef[0],
                "vy": None if sol.vel_ecef is None else sol.vel_ecef[1],
                "vz": None if sol.vel_ecef is None else sol.vel_ecef[2],
                "user_clk_offset": sol.clock_bias_s,
                "gdop": sol.gdop, "pdop": sol.pdop, "hdop": sol.hdop,
                "vdop": sol.vdop, "valid_sats": sol.n_sats,
            }).encode()
        self._sock.sendto(payload, self.address)
        return len(payload)

    # -- ephemeris ------------------------------------------------------------

    def send_gps_ephemeris(self, eph) -> int:
        """Stream one decoded GPS ephemeris (Monitor_Ephemeris_Udp_Sink
        counterpart, 'G'-tagged GpsEphemeris protobuf;
        monitor_ephemeris_udp_sink.cc:80-96)."""
        m = gps_ephemeris_pb2.GpsEphemeris()
        _fill_kepler(m, eph)
        m.SV_health = int(eph.sv_health)
        m.TGD = float(eph.tgd_s)
        m.IODC = int(eph.iodc)
        m.IODE_SF2 = int(eph.iode)
        m.IODE_SF3 = int(eph.iode)
        payload = b"G" + m.SerializeToString()
        self._sock.sendto(payload, self.address)
        return len(payload)

    def send_galileo_ephemeris(self, eph, *, bgd_e1e5a: float = 0.0,
                               bgd_e1e5b: float | None = None) -> int:
        """Stream one decoded Galileo ephemeris ('E'-tagged
        GalileoEphemeris protobuf). Our INAV assembler stores the BGD
        playing the TGD role in ``tgd_s`` (telemetry/galileo_inav.py);
        pass the E1-E5a term explicitly when both are known."""
        m = galileo_ephemeris_pb2.GalileoEphemeris()
        _fill_kepler(m, eph)
        m.E1B_HS = int(eph.sv_health)
        m.IOD_ephemeris = int(eph.iode)
        m.IOD_nav = int(eph.iode)
        m.BGD_E1E5a = float(bgd_e1e5a)
        m.BGD_E1E5b = float(eph.tgd_s if bgd_e1e5b is None else bgd_e1e5b)
        payload = b"E" + m.SerializeToString()
        self._sock.sendto(payload, self.address)
        return len(payload)

    # -- nav messages ---------------------------------------------------------

    def send_nav_message(self, *, system: str, signal: str, prn: int,
                         tow_ms: int, bits: str) -> int:
        """Stream one decoded nav-message unit (navMsg wire message;
        nav_message_udp_sink counterpart)."""
        m = nav_message_pb2.navMsg()
        m.system = system
        m.signal = signal
        m.prn = int(prn)
        m.tow_at_current_symbol_ms = int(tow_ms)
        m.nav_message = bits
        payload = m.SerializeToString()
        self._sock.sendto(payload, self.address)
        return len(payload)

    def close(self) -> None:
        self._sock.close()
