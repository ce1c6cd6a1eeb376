"""RTCM 3.2 message encoder/decoder + TCP broadcast server.

Counterpart of the reference's RTCM printer stack
(reference: src/algorithms/PVT/libs/rtcm.{h,cc} — 6.7k LoC encoder with
TCP server — and rtcm_printer.{h,cc}; wired from rtklib_pvt_gs.cc:2286-2400
which emits MT1019/MT1045 at `rtcm_MT1019_rate_ms` and one MSM per
signal at `rtcm_MSM_rate_ms`).

Implemented messages (RTCM STANDARD 10403.2 layouts):

- framing: 0xD3 preamble, 10-bit length, CRC-24Q (poly 0x1864CFB);
- MT1005/1006: station antenna reference point (+height);
- MT1019: GPS ephemeris (Kepler + clock, DF076-DF103 fields);
- MT1020: GLONASS ephemeris (state vector, sign-magnitude fields);
- MT1045: Galileo F/NAV ephemeris;
- MSM4 and MSM7 for GPS (1074/1077) and Galileo (1094/1097) with
  satellite/signal/cell masks and fine range/phase/CNR cells.

Everything is pure-Python bit packing on the host — RTCM output is an
observability stream (bytes/s), far off the device hot path.
"""

from __future__ import annotations

import math
import socket
import threading
from dataclasses import dataclass, field

from gnss_sdr_tpu.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu.pvt.glonass_ephemeris import GlonassEphemeris

SPEED_OF_LIGHT = 299792458.0
_CRC24_POLY = 0x1864CFB

# semicircle <-> radian
_SC = math.pi


def crc24q_bytes(data: bytes) -> int:
    reg = 0
    for byte in data:
        reg ^= byte << 16
        for _ in range(8):
            reg <<= 1
            if reg & 0x1000000:
                reg ^= _CRC24_POLY
    return reg & 0xFFFFFF


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, value: int, n: int) -> "BitWriter":
        value = int(value) & ((1 << n) - 1)
        self.bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))
        return self

    def s(self, value: int, n: int) -> "BitWriter":
        """Two's-complement signed."""
        return self.u(int(value) & ((1 << n) - 1), n)

    def sm(self, value: int, n: int) -> "BitWriter":
        """Sign-magnitude signed (GLONASS data fields, DF111 etc.)."""
        v = int(value)
        sign = 1 if v < 0 else 0
        return self.u((sign << (n - 1)) | (abs(v) & ((1 << (n - 1)) - 1)), n)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * ((8 - len(self.bits) % 8) % 8)
        return bytes(
            int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8))


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def sm(self, n: int) -> int:
        v = self.u(n)
        mag = v & ((1 << (n - 1)) - 1)
        return -mag if v >> (n - 1) else mag


def frame(payload: bytes) -> bytes:
    """Wrap a payload in the RTCM 3 transport frame."""
    if len(payload) > 1023:
        raise ValueError("RTCM payload too long")
    head = bytes([0xD3, (len(payload) >> 8) & 0x03, len(payload) & 0xFF])
    crc = crc24q_bytes(head + payload)
    return head + payload + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF,
                                   crc & 0xFF])


def deframe(data: bytes) -> list[bytes]:
    """Extract payloads of all valid frames in a byte stream."""
    out = []
    i = 0
    while i + 6 <= len(data):
        if data[i] != 0xD3:
            i += 1
            continue
        length = ((data[i + 1] & 0x03) << 8) | data[i + 2]
        end = i + 3 + length + 3
        if end > len(data):
            # either a false preamble inside noise or a truncated final
            # frame: advance one byte and keep scanning
            i += 1
            continue
        payload = data[i + 3:i + 3 + length]
        crc = (data[end - 3] << 16) | (data[end - 2] << 8) | data[end - 1]
        if crc24q_bytes(data[i:i + 3 + length]) == crc:
            out.append(payload)
            i = end
        else:
            i += 1
    return out


def message_number(payload: bytes) -> int:
    return (payload[0] << 4) | (payload[1] >> 4)


# ---------------------------------------------------------------------------
# MT1005 / MT1006 — station antenna reference point
# ---------------------------------------------------------------------------


def encode_mt1005(station_id: int, ecef_x: float, ecef_y: float,
                  ecef_z: float, *, gps: bool = True, glonass: bool = False,
                  galileo: bool = True, height_m: float | None = None) -> bytes:
    w = BitWriter()
    w.u(1006 if height_m is not None else 1005, 12)
    w.u(station_id, 12)
    w.u(0, 6)               # ITRF realization year
    w.u(1 if gps else 0, 1)
    w.u(1 if glonass else 0, 1)
    w.u(1 if galileo else 0, 1)
    w.u(0, 1)               # reference-station indicator
    w.s(round(ecef_x * 1e4), 38)
    w.u(0, 1)               # single receiver oscillator
    w.u(0, 1)               # reserved
    w.s(round(ecef_y * 1e4), 38)
    w.u(0, 2)               # quarter cycle indicator
    w.s(round(ecef_z * 1e4), 38)
    if height_m is not None:
        w.u(round(height_m * 1e4), 16)
    return w.to_bytes()


def decode_mt1005(payload: bytes) -> dict:
    r = BitReader(payload)
    mt = r.u(12)
    out = {"mt": mt, "station_id": r.u(12)}
    r.u(6)
    out["gps"] = bool(r.u(1))
    out["glonass"] = bool(r.u(1))
    out["galileo"] = bool(r.u(1))
    r.u(1)
    out["x"] = r.s(38) * 1e-4
    r.u(2)
    out["y"] = r.s(38) * 1e-4
    r.u(2)
    out["z"] = r.s(38) * 1e-4
    if mt == 1006:
        out["height"] = r.u(16) * 1e-4
    return out


# ---------------------------------------------------------------------------
# MT1019 — GPS ephemeris
# ---------------------------------------------------------------------------


def encode_mt1019(eph: GpsEphemeris) -> bytes:
    w = BitWriter()
    w.u(1019, 12)
    w.u(eph.prn, 6)
    w.u(eph.week_number % 1024, 10)
    w.u(getattr(eph, "sv_accuracy", 0), 4)
    w.u(getattr(eph, "code_on_l2", 1), 2)
    w.s(round(eph.idot_rad_s / _SC * 2**43), 14)
    w.u(eph.iode & 0xFF, 8)
    w.u(round(eph.toc_s / 16.0), 16)
    w.s(round(eph.af2 * 2**55), 8)
    w.s(round(eph.af1 * 2**43), 16)
    w.s(round(eph.af0 * 2**31), 22)
    w.u(eph.iodc & 0x3FF, 10)
    w.s(round(eph.crs_m * 2**5), 16)
    w.s(round(eph.delta_n_rad_s / _SC * 2**43), 16)
    w.s(round(eph.m0_rad / _SC * 2**31), 32)
    w.s(round(eph.cuc_rad * 2**29), 16)
    w.u(round(eph.ecc * 2**33), 32)
    w.s(round(eph.cus_rad * 2**29), 16)
    w.u(round(eph.sqrt_a * 2**19), 32)
    w.u(round(eph.toe_s / 16.0), 16)
    w.s(round(eph.cic_rad * 2**29), 16)
    w.s(round(eph.omega0_rad / _SC * 2**31), 32)
    w.s(round(eph.cis_rad * 2**29), 16)
    w.s(round(eph.i0_rad / _SC * 2**31), 32)
    w.s(round(eph.crc_m * 2**5), 16)
    w.s(round(eph.omega_rad / _SC * 2**31), 32)
    w.s(round(eph.omega_dot_rad_s / _SC * 2**43), 24)
    w.s(round(eph.tgd_s * 2**31), 8)
    w.u(eph.sv_health, 6)
    w.u(0, 1)  # L2 P data flag
    w.u(0, 1)  # fit interval
    return w.to_bytes()


def decode_mt1019(payload: bytes) -> GpsEphemeris:
    r = BitReader(payload)
    if r.u(12) != 1019:
        raise ValueError("not an MT1019 payload")
    eph = GpsEphemeris()
    eph.prn = r.u(6)
    eph.week_number = r.u(10)
    r.u(4)  # URA
    r.u(2)  # code on L2
    eph.idot_rad_s = r.s(14) * 2.0**-43 * _SC
    eph.iode = r.u(8)
    eph.toc_s = r.u(16) * 16.0
    eph.af2 = r.s(8) * 2.0**-55
    eph.af1 = r.s(16) * 2.0**-43
    eph.af0 = r.s(22) * 2.0**-31
    eph.iodc = r.u(10)
    eph.crs_m = r.s(16) * 2.0**-5
    eph.delta_n_rad_s = r.s(16) * 2.0**-43 * _SC
    eph.m0_rad = r.s(32) * 2.0**-31 * _SC
    eph.cuc_rad = r.s(16) * 2.0**-29
    eph.ecc = r.u(32) * 2.0**-33
    eph.cus_rad = r.s(16) * 2.0**-29
    eph.sqrt_a = r.u(32) * 2.0**-19
    eph.toe_s = r.u(16) * 16.0
    eph.cic_rad = r.s(16) * 2.0**-29
    eph.omega0_rad = r.s(32) * 2.0**-31 * _SC
    eph.cis_rad = r.s(16) * 2.0**-29
    eph.i0_rad = r.s(32) * 2.0**-31 * _SC
    eph.crc_m = r.s(16) * 2.0**-5
    eph.omega_rad = r.s(32) * 2.0**-31 * _SC
    eph.omega_dot_rad_s = r.s(24) * 2.0**-43 * _SC
    eph.tgd_s = r.s(8) * 2.0**-31
    eph.sv_health = r.u(6)
    return eph


# ---------------------------------------------------------------------------
# MT1045 — Galileo F/NAV ephemeris (same Kepler container)
# ---------------------------------------------------------------------------


def encode_mt1045(eph: GpsEphemeris) -> bytes:
    w = BitWriter()
    w.u(1045, 12)
    w.u(eph.prn, 6)
    w.u(eph.week_number % 4096, 12)
    w.u(eph.iode & 0x3FF, 10)   # IODnav
    w.u(getattr(eph, "sisa", 0), 8)
    w.s(round(eph.idot_rad_s / _SC * 2**43), 14)
    w.u(round(eph.toc_s / 60.0), 14)
    w.s(round(eph.af2 * 2**59), 6)
    w.s(round(eph.af1 * 2**46), 21)
    w.s(round(eph.af0 * 2**34), 31)
    w.s(round(eph.crs_m * 2**5), 16)
    w.s(round(eph.delta_n_rad_s / _SC * 2**43), 16)
    w.s(round(eph.m0_rad / _SC * 2**31), 32)
    w.s(round(eph.cuc_rad * 2**29), 16)
    w.u(round(eph.ecc * 2**33), 32)
    w.s(round(eph.cus_rad * 2**29), 16)
    w.u(round(eph.sqrt_a * 2**19), 32)
    w.u(round(eph.toe_s / 60.0), 14)
    w.s(round(eph.cic_rad * 2**29), 16)
    w.s(round(eph.omega0_rad / _SC * 2**31), 32)
    w.s(round(eph.cis_rad * 2**29), 16)
    w.s(round(eph.i0_rad / _SC * 2**31), 32)
    w.s(round(eph.crc_m * 2**5), 16)
    w.s(round(eph.omega_rad / _SC * 2**31), 32)
    w.s(round(eph.omega_dot_rad_s / _SC * 2**43), 24)
    w.s(round(eph.tgd_s * 2**32), 10)  # BGD E1/E5a
    w.u(eph.sv_health & 0x3, 2)        # E5a signal health
    w.u(0, 1)                          # E5a data validity
    w.u(0, 7)                          # reserved
    return w.to_bytes()


def decode_mt1045(payload: bytes) -> GpsEphemeris:
    r = BitReader(payload)
    if r.u(12) != 1045:
        raise ValueError("not an MT1045 payload")
    eph = GpsEphemeris()
    eph.prn = r.u(6)
    eph.week_number = r.u(12)
    eph.iode = eph.iodc = r.u(10)
    r.u(8)
    eph.idot_rad_s = r.s(14) * 2.0**-43 * _SC
    eph.toc_s = r.u(14) * 60.0
    eph.af2 = r.s(6) * 2.0**-59
    eph.af1 = r.s(21) * 2.0**-46
    eph.af0 = r.s(31) * 2.0**-34
    eph.crs_m = r.s(16) * 2.0**-5
    eph.delta_n_rad_s = r.s(16) * 2.0**-43 * _SC
    eph.m0_rad = r.s(32) * 2.0**-31 * _SC
    eph.cuc_rad = r.s(16) * 2.0**-29
    eph.ecc = r.u(32) * 2.0**-33
    eph.cus_rad = r.s(16) * 2.0**-29
    eph.sqrt_a = r.u(32) * 2.0**-19
    eph.toe_s = r.u(14) * 60.0
    eph.cic_rad = r.s(16) * 2.0**-29
    eph.omega0_rad = r.s(32) * 2.0**-31 * _SC
    eph.cis_rad = r.s(16) * 2.0**-29
    eph.i0_rad = r.s(32) * 2.0**-31 * _SC
    eph.crc_m = r.s(16) * 2.0**-5
    eph.omega_rad = r.s(32) * 2.0**-31 * _SC
    eph.omega_dot_rad_s = r.s(24) * 2.0**-43 * _SC
    eph.tgd_s = r.s(10) * 2.0**-32
    eph.sv_health = r.u(2)
    return eph


# ---------------------------------------------------------------------------
# MT1020 — GLONASS ephemeris (sign-magnitude data fields)
# ---------------------------------------------------------------------------


def encode_mt1020(eph: GlonassEphemeris) -> bytes:
    w = BitWriter()
    w.u(1020, 12)
    w.u(eph.slot, 6)
    w.u(eph.freq_slot + 7, 5)
    w.u(0, 1).u(0, 1).u(0, 2)          # health/avail/P1
    w.u(0, 12)                          # tk
    w.u(0, 1).u(0, 1)                   # Bn MSB, P2
    w.u(round(eph.tb_s / 900.0), 7)     # tb in 15-min units
    for axis in range(3):
        w.sm(round(eph.vel_m_s[axis] / 1e3 * 2**20), 24)
        w.sm(round(eph.pos_m[axis] / 1e3 * 2**11), 27)
        w.sm(round(eph.acc_m_s2[axis] / 1e3 * 2**30), 5)
    w.u(0, 1)                           # P3
    w.sm(round(eph.gamma_n * 2**40), 11)
    w.u(0, 2).u(0, 1)                   # P, ln
    w.sm(round(eph.tau_n_s * 2**30), 22)
    w.sm(0, 5)                          # delta tau
    w.u(0, 5)                           # En (age)
    w.u(0, 1).u(0, 4)                   # P4, Ft
    w.u(0, 11)                          # Nt
    w.u(0, 2)                           # M
    w.u(0, 1)                           # additional data available
    w.u(0, 11).s(0, 32).u(0, 5).s(0, 22).u(0, 1).u(0, 7)
    return w.to_bytes()


def decode_mt1020(payload: bytes) -> GlonassEphemeris:
    r = BitReader(payload)
    if r.u(12) != 1020:
        raise ValueError("not an MT1020 payload")
    eph = GlonassEphemeris()
    eph.slot = r.u(6)
    eph.freq_slot = r.u(5) - 7
    r.u(1), r.u(1), r.u(2), r.u(12), r.u(1), r.u(1)
    eph.tb_s = r.u(7) * 900.0
    pos, vel, acc = [0.0] * 3, [0.0] * 3, [0.0] * 3
    for axis in range(3):
        vel[axis] = r.sm(24) * 2.0**-20 * 1e3
        pos[axis] = r.sm(27) * 2.0**-11 * 1e3
        acc[axis] = r.sm(5) * 2.0**-30 * 1e3
    eph.pos_m, eph.vel_m_s, eph.acc_m_s2 = tuple(pos), tuple(vel), tuple(acc)
    r.u(1)
    eph.gamma_n = r.sm(11) * 2.0**-40
    r.u(2), r.u(1)
    eph.tau_n_s = r.sm(22) * 2.0**-30
    return eph


# ---------------------------------------------------------------------------
# MSM (Multiple Signal Messages)
# ---------------------------------------------------------------------------

# signal-mask slot (1-based position in DF395) per (system, signal code)
# RTCM 10403.2 Tables 3.5-91 (GPS) and 3.5-99 (Galileo)
_MSM_SIGNAL_SLOT = {
    ("G", "1C"): 2,   # GPS L1 C/A
    ("G", "2S"): 15,  # GPS L2C (M)
    ("G", "L5"): 22,  # GPS L5 I
    ("E", "1B"): 4,   # Galileo E1 B
    ("E", "5X"): 22,  # Galileo E5a I
    ("E", "7X"): 14,  # Galileo E5b I
}

_MSM_BASE = {"G": 1070, "E": 1090, "R": 1080, "C": 1120}

RANGE_MS = 1.0e3 / SPEED_OF_LIGHT  # not used; kept for clarity


@dataclass
class MsmObservation:
    prn: int
    signal: str              # e.g. "1C"
    pseudorange_m: float
    carrier_phase_cycles: float = 0.0
    doppler_hz: float = 0.0
    cn0_dbhz: float = 0.0
    lock_time_s: float = 0.0
    wavelength_m: float = 0.19029367279836487  # L1 default


def _lock_time_indicator(lock_s: float, msm7: bool) -> int:
    """DF402 (4-bit) / DF407 (10-bit) lock-time indicators."""
    if msm7:
        # DF407: piecewise table; use the standard recursive mapping
        ms = lock_s * 1e3
        if ms < 64:
            return int(ms)
        n = 1
        while ms >= 64 * 2 ** n and n < 21:
            n += 1
        n -= 1
        return int((ms / 2 ** n) + n * 32) if n <= 20 else 704
    table = [0, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
             32768, 65536, 131072, 262144, 524288]
    ms = lock_s * 1e3
    for i in range(15, -1, -1):
        if ms >= table[i]:
            return i
    return 0


def encode_msm(system: str, observations: list[MsmObservation],
               *, station_id: int = 1234, epoch_time_ms: int = 0,
               msm: int = 7, multiple_message: bool = False) -> bytes:
    """Encode one MSM4 or MSM7 message for one system."""
    if msm not in (4, 7):
        raise ValueError("only MSM4 and MSM7 are implemented")
    mt = _MSM_BASE[system] + msm
    sats = sorted({o.prn for o in observations})
    slots = sorted({_MSM_SIGNAL_SLOT[(system, o.signal)] for o in observations})
    cell = {(o.prn, _MSM_SIGNAL_SLOT[(system, o.signal)]): o
            for o in observations}
    w = BitWriter()
    w.u(mt, 12)
    w.u(station_id, 12)
    w.u(epoch_time_ms, 30)
    w.u(1 if multiple_message else 0, 1)
    w.u(0, 3)   # IODS
    w.u(0, 7)   # reserved
    w.u(0, 2)   # clock steering
    w.u(0, 2)   # external clock
    w.u(0, 1)   # smoothing type
    w.u(0, 3)   # smoothing interval
    for prn in range(1, 65):
        w.u(1 if prn in sats else 0, 1)       # DF394 satellite mask
    for s in range(1, 33):
        w.u(1 if s in slots else 0, 1)        # DF395 signal mask
    for prn in sats:                           # DF396 cell mask
        for s in slots:
            w.u(1 if (prn, s) in cell else 0, 1)
    # satellite data — field-by-field over all satellites
    rough_ms: dict[int, float] = {}
    for prn in sats:
        obs = [cell[(prn, s)] for s in slots if (prn, s) in cell]
        rng_ms = obs[0].pseudorange_m / SPEED_OF_LIGHT * 1e3
        rough_ms[prn] = rng_ms
        w.u(int(rng_ms), 8)                   # DF397 integer ms
    if msm == 7:
        for prn in sats:
            w.u(0, 4)                          # extended sat info
    for prn in sats:
        frac = rough_ms[prn] - int(rough_ms[prn])
        w.u(round(frac * 1024) & 0x3FF, 10)   # DF398 rough range mod 1 ms
        rough_ms[prn] = int(rough_ms[prn]) + round(frac * 1024) / 1024.0
    if msm == 7:
        for prn in sats:
            obs = [cell[(prn, s)] for s in slots if (prn, s) in cell]
            rate = -obs[0].doppler_hz * obs[0].wavelength_m  # m/s
            w.s(round(rate), 14)               # DF399 rough phase range rate
    # signal data — field-by-field over all cells
    cells = [(prn, s) for prn in sats for s in slots if (prn, s) in cell]
    if msm == 4:
        for prn, s in cells:
            o = cell[(prn, s)]
            fine = o.pseudorange_m / SPEED_OF_LIGHT * 1e3 - rough_ms[prn]
            w.s(round(fine * 2**24), 15)       # DF400
        for prn, s in cells:
            o = cell[(prn, s)]
            phase_ms = (o.carrier_phase_cycles * o.wavelength_m /
                        SPEED_OF_LIGHT * 1e3)
            fine = phase_ms - rough_ms[prn]
            w.s(round(fine * 2**29), 22)       # DF401
        for prn, s in cells:
            w.u(_lock_time_indicator(cell[(prn, s)].lock_time_s, False), 4)
        for _ in cells:
            w.u(0, 1)                          # half-cycle ambiguity
        for prn, s in cells:
            w.u(round(cell[(prn, s)].cn0_dbhz), 6)  # DF403
    else:
        for prn, s in cells:
            o = cell[(prn, s)]
            fine = o.pseudorange_m / SPEED_OF_LIGHT * 1e3 - rough_ms[prn]
            w.s(round(fine * 2**29), 20)       # DF405
        for prn, s in cells:
            o = cell[(prn, s)]
            phase_ms = (o.carrier_phase_cycles * o.wavelength_m /
                        SPEED_OF_LIGHT * 1e3)
            fine = phase_ms - rough_ms[prn]
            w.s(round(fine * 2**31), 24)       # DF406
        for prn, s in cells:
            w.u(_lock_time_indicator(cell[(prn, s)].lock_time_s, True), 10)
        for _ in cells:
            w.u(0, 1)
        for prn, s in cells:
            w.u(round(cell[(prn, s)].cn0_dbhz * 16), 10)  # DF408 2^-4 dBHz
        for prn, s in cells:
            o = cell[(prn, s)]
            rate = -o.doppler_hz * o.wavelength_m
            fine_rate = rate - round(rate)
            w.s(round(fine_rate * 1e4), 15)    # DF404 0.0001 m/s
    return w.to_bytes()


def decode_msm(payload: bytes) -> dict:
    """Decode an MSM4/MSM7 payload back to observations (for tests and
    for the nav-listener role)."""
    r = BitReader(payload)
    mt = r.u(12)
    system = {107: "G", 109: "E", 108: "R", 112: "C"}[mt // 10]
    msm = mt % 10
    if msm not in (4, 7):
        raise ValueError("only MSM4/MSM7 decode supported")
    out = {"mt": mt, "system": system, "station_id": r.u(12),
           "epoch_time_ms": r.u(30)}
    r.u(1), r.u(3), r.u(7), r.u(2), r.u(2), r.u(1), r.u(3)
    sats = [prn for prn in range(1, 65) if r.u(1)]
    slots = [s for s in range(1, 33) if r.u(1)]
    cellflags = [[bool(r.u(1)) for _ in slots] for _ in sats]
    rough_int = {prn: r.u(8) for prn in sats}
    if msm == 7:
        for _ in sats:
            r.u(4)
    rough = {prn: rough_int[prn] + r.u(10) / 1024.0 for prn in sats}
    rough_rate = {}
    if msm == 7:
        rough_rate = {prn: r.s(14) for prn in sats}
    cells = [(prn, s) for i, prn in enumerate(sats)
             for j, s in enumerate(slots) if cellflags[i][j]]
    obs: list[dict] = [{"prn": prn, "slot": s} for prn, s in cells]
    if msm == 4:
        fines = [r.s(15) * 2.0**-24 for _ in cells]
        phases = [r.s(22) * 2.0**-29 for _ in cells]
        locks = [r.u(4) for _ in cells]
        halfs = [r.u(1) for _ in cells]
        cn0s = [r.u(6) for _ in cells]
        rates = [0.0] * len(cells)
    else:
        fines = [r.s(20) * 2.0**-29 for _ in cells]
        phases = [r.s(24) * 2.0**-31 for _ in cells]
        locks = [r.u(10) for _ in cells]
        halfs = [r.u(1) for _ in cells]
        cn0s = [r.u(10) / 16.0 for _ in cells]
        rates = [r.s(15) * 1e-4 for _ in cells]
    for k, (prn, s) in enumerate(cells):
        ms = rough[prn] + fines[k]
        obs[k]["pseudorange_m"] = ms * SPEED_OF_LIGHT * 1e-3
        obs[k]["phaserange_m"] = (rough[prn] + phases[k]) * SPEED_OF_LIGHT * 1e-3
        obs[k]["cn0_dbhz"] = cn0s[k]
        obs[k]["lock"] = locks[k]
        obs[k]["half_cycle"] = halfs[k]
        if msm == 7:
            obs[k]["range_rate_m_s"] = rough_rate[prn] + rates[k]
    out["observations"] = obs
    del halfs
    return out


# ---------------------------------------------------------------------------
# Printer + TCP server (rtcm_printer / Rtcm::run_server role)
# ---------------------------------------------------------------------------


class RtcmTcpServer:
    """Broadcasts RTCM frames to connected TCP clients
    (reference: Rtcm::run_server, rtcm.h; default port 2101)."""

    def __init__(self, port: int = 2101, host: str = "127.0.0.1"):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)

    def send(self, frame_bytes: bytes) -> None:
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(frame_bytes)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def close(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()


@dataclass
class RtcmPrinter:
    """Rate-gated RTCM emission driven by the PVT block
    (reference: rtklib_pvt_gs.cc:2286-2400)."""

    station_id: int = 1234
    mt1019_rate_ms: int = 5000
    msm_rate_ms: int = 1000
    msm: int = 7
    server: RtcmTcpServer | None = None
    frames: list[bytes] = field(default_factory=list)

    def epoch(self, rx_time_ms: int,
              gps_ephemerides: dict[int, GpsEphemeris],
              observations: list[MsmObservation],
              galileo_ephemerides: dict[int, GpsEphemeris] | None = None) -> list[bytes]:
        out: list[bytes] = []
        if self.mt1019_rate_ms and rx_time_ms % self.mt1019_rate_ms == 0:
            for eph in gps_ephemerides.values():
                out.append(frame(encode_mt1019(eph)))
            for eph in (galileo_ephemerides or {}).values():
                out.append(frame(encode_mt1045(eph)))
        if self.msm_rate_ms and rx_time_ms % self.msm_rate_ms == 0:
            by_system: dict[str, list[MsmObservation]] = {}
            for o in observations:
                sysc = "G" if o.signal in ("1C", "2S", "L5") else "E"
                by_system.setdefault(sysc, []).append(o)
            for sysc, obs in sorted(by_system.items()):
                out.append(frame(encode_msm(
                    sysc, obs, station_id=self.station_id,
                    epoch_time_ms=rx_time_ms % 604800000, msm=self.msm)))
        self.frames.extend(out)
        if self.server is not None:
            for f in out:
                self.server.send(f)
        return out
