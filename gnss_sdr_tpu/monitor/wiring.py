"""Config-driven UDP monitor wiring.

Counterpart of the reference's monitor assembly in the flowgraph and the
PVT adapter (gnss_flowgraph.cc:190-275: ``Monitor``/``AcquisitionMonitor``/
``TrackingMonitor``/``NavDataMonitor`` groups; rtklib_pvt.cc:846-864:
``PVT.enable_monitor`` and ``PVT.enable_monitor_ephemeris``). Same keys,
same defaults, same default ports (1234/1235/1236/1237). Multiple client
addresses are accepted separated by ``_`` (the reference's convention)
or ``,``.

The receivers hold an optional ``monitors`` attribute; when set, the
scan/production host loops call the hooks below at the natural choke
points (per-period tracking rows, each PVT fix, each newly assembled
ephemeris, each decoded nav page).
"""

from __future__ import annotations


def _addresses(raw: str) -> list[str]:
    return [a for a in raw.replace("_", ",").split(",") if a]


class _Sink:
    """One monitor group: N client endpoints + a decimation counter."""

    def __init__(self, addresses: list[str], port: int, decimation: int):
        # protobuf is needed only once a monitor group is enabled
        from gnss_sdr_tpu.monitor.udp_monitor import UdpMonitor

        self.monitors = [UdpMonitor(a, port) for a in addresses]
        self.decimation = max(1, int(decimation))
        self._count = 0

    def due(self) -> bool:
        self._count += 1
        if self._count >= self.decimation:
            self._count = 0
            return True
        return False

    def close(self) -> None:
        for m in self.monitors:
            m.close()


class ConfigMonitors:
    """The set of UDP monitors a configuration enables."""

    def __init__(self, tracking=None, acquisition=None, observables=None,
                 pvt=None, ephemeris=None, nav=None):
        self.tracking = tracking
        self.acquisition = acquisition
        self.observables = observables
        self.pvt_sink = pvt
        self.ephemeris_sink = ephemeris
        self.nav = nav

    @classmethod
    def from_config(cls, config) -> "ConfigMonitors | None":
        """Build the enabled sinks; None when no group is enabled."""
        def group(role: str, default_port: int) -> _Sink | None:
            if not config.property(f"{role}.enable_monitor", False):
                return None
            return _Sink(
                _addresses(config.property(
                    f"{role}.client_addresses", "127.0.0.1")),
                config.property(f"{role}.udp_port", default_port),
                config.property(f"{role}.decimation_factor", 1))

        nav = None
        if config.property("NavDataMonitor.enable_monitor", False):
            nav = _Sink(
                _addresses(config.property(
                    "NavDataMonitor.client_addresses", "127.0.0.1")),
                config.property("NavDataMonitor.port", 1237), 1)
        pvt = None
        if config.property("PVT.enable_monitor", False):
            pvt = _Sink(
                _addresses(config.property(
                    "PVT.monitor_client_addresses", "127.0.0.1")),
                config.property("PVT.monitor_udp_port", 1234), 1)
        eph = None
        if config.property("PVT.enable_monitor_ephemeris", False):
            eph = _Sink(
                _addresses(config.property(
                    "PVT.monitor_ephemeris_client_addresses", "127.0.0.1")),
                config.property("PVT.monitor_ephemeris_udp_port", 1234), 1)
        mons = cls(
            tracking=group("TrackingMonitor", 1236),
            acquisition=group("AcquisitionMonitor", 1235),
            observables=group("Monitor", 1234),
            pvt=pvt, ephemeris=eph, nav=nav)
        if not any((mons.tracking, mons.acquisition, mons.observables,
                    mons.pvt_sink, mons.ephemeris_sink, mons.nav)):
            return None
        return mons

    # -- hooks called by the receivers ----------------------------------

    def period(self, records) -> None:
        """Per-period tracking rows (TrackingMonitor group)."""
        if self.tracking is not None:
            due = [p for p in records if self.tracking.due()]
            if due:
                for m in self.tracking.monitors:
                    m.send_observables(due)

    def epoch(self, synchros) -> None:
        """One observables epoch (Monitor group taps the aligned rows)."""
        if self.observables is not None and self.observables.due():
            for m in self.observables.monitors:
                m.send_observables(synchros)

    def acq(self, synchro) -> None:
        """One positive acquisition verdict (AcquisitionMonitor group)."""
        if self.acquisition is not None and self.acquisition.due():
            for m in self.acquisition.monitors:
                m.send_observables([synchro])

    def pvt(self, sol) -> None:
        if self.pvt_sink is not None:
            for m in self.pvt_sink.monitors:
                m.send_pvt(sol)

    def ephemeris(self, system: str, eph) -> None:
        """One newly assembled broadcast ephemeris ('G' or 'E')."""
        if self.ephemeris_sink is None:
            return
        for m in self.ephemeris_sink.monitors:
            if system == "E":
                m.send_galileo_ephemeris(eph)
            elif system == "G":
                m.send_gps_ephemeris(eph)

    def nav_message(self, **kw) -> None:
        if self.nav is not None:
            for m in self.nav.monitors:
                m.send_nav_message(**kw)

    def close(self) -> None:
        for s in (self.tracking, self.acquisition, self.observables,
                  self.pvt_sink, self.ephemeris_sink, self.nav):
            if s is not None:
                s.close()
