"""Observability / telemetry outputs (reference layer L8).

Counterparts of the reference's PVT printers
(/root/reference/src/algorithms/PVT/libs/{nmea_printer,kml_printer,
gpx_printer,geojson_printer}.cc), per-block dump files (+ MATLAB .mat
export via scipy, matching the matio-based save_matfile paths), and the
UDP monitor streams (src/core/monitor/).
"""

from gnss_sdr_tpu.monitor.dumps import TrackingDump
from gnss_sdr_tpu.monitor.geo_writers import (
    GeoJsonWriter,
    GpxWriter,
    KmlWriter,
)
from gnss_sdr_tpu.monitor.nmea import nmea_gga, nmea_rmc, nmea_sentence

__all__ = [
    "TrackingDump",
    "GeoJsonWriter",
    "GpxWriter",
    "KmlWriter",
    "nmea_gga",
    "nmea_rmc",
    "nmea_sentence",
    "UdpMonitor",
]


def __getattr__(name):
    # the UDP monitors need protobuf, which only monitored deployments
    # install: import them on first use, not with the package
    if name == "UdpMonitor":
        from gnss_sdr_tpu.monitor.udp_monitor import UdpMonitor

        return UdpMonitor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
