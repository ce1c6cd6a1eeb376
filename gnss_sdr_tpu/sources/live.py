"""Live streaming signal sources: FIFO (named pipe), UDP, timestamped file.

Counterparts of the reference adapters
(/root/reference/src/algorithms/signal_source/adapters/):

- ``FifoSignalSource`` — fifo_signal_source.cc + fifo_reader.cc: blocking
  reads of interleaved samples from a named pipe, same item types.
- ``UdpSignalSource`` — custom_udp_signal_source.cc: datagrams of
  interleaved IQ (``sample_type`` cbyte/cshort/gr_complex), optional
  IQ swap, single RF channel per socket.
- ``FileTimestampSignalSource`` — file_timestamp_signal_source.cc +
  libs/gnss_sdr_timestamp.cc: a capture file plus a binary sidecar of
  (uint64 sample_count, int32 week, int32 tow_ms) records that pin
  absolute GNSS time onto sample indices.

All sources deliver numpy complex64 blocks on the host; the receiver
moves them to the device as planar (re, im) float32 — device code never
sees a live socket.
"""

from __future__ import annotations

import os
import socket
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

from gnss_sdr_tpu.sources.file_source import ITEM_TYPES, FileSignalSource


def _interleaved_to_complex(raw: np.ndarray, per_sample: int,
                            iq_swap: bool = False) -> np.ndarray:
    raw = raw.astype(np.float32)
    if per_sample == 2:
        i, q = raw[0::2], raw[1::2]
        if iq_swap:
            i, q = q, i
        return (i + 1j * q).astype(np.complex64)
    return raw.astype(np.complex64)


class FifoSignalSource:
    """Blocking reader of interleaved samples from a named pipe (or any
    stream-like file object that grows).

    fifo_reader.cc semantics: partial reads retry until the requested
    block is complete; EOF with the writer still attached clears and
    retries (:68-84).
    """

    def __init__(self, filename: str | os.PathLike,
                 sampling_frequency: float,
                 item_type: str = "ishort"):
        if item_type not in ITEM_TYPES:
            raise ValueError(f"unknown item_type {item_type!r}")
        self.fs = float(sampling_frequency)
        self.item_type = item_type
        self._dtype, self._per_sample = ITEM_TYPES[item_type]
        # opened lazily so constructing the source does not block on a
        # pipe with no writer yet
        self._filename = str(filename)
        self._file = None
        self._leftover = b""
        self.samples_delivered = 0

    def _ensure_open(self):
        if self._file is None:
            self._file = open(self._filename, "rb", buffering=0)

    def read_block(self, n_samples: int, max_retries: int = 10_000
                   ) -> np.ndarray:
        """Read exactly ``n_samples`` complex samples (blocking)."""
        self._ensure_open()
        need = n_samples * self._per_sample * self._dtype.itemsize
        buf = bytearray(self._leftover)
        retries = 0
        while len(buf) < need:
            chunk = self._file.read(need - len(buf))
            if chunk:
                buf.extend(chunk)
                retries = 0
            else:
                retries += 1
                if retries > max_retries:
                    raise EOFError(
                        f"FIFO {self._filename}: writer gone after "
                        f"{len(buf)}/{need} bytes")
        self._leftover = b""
        raw = np.frombuffer(bytes(buf[:need]), dtype=self._dtype)
        self.samples_delivered += n_samples
        return _interleaved_to_complex(raw, self._per_sample)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class UdpSignalSource:
    """Receives IQ datagrams on a UDP port into a bounded ring buffer.

    custom_udp_signal_source.cc keys: ``port``, ``sample_type``
    (cbyte default, :54), ``IQ_swap`` (:52). A background thread drains
    the socket; ``read_block`` blocks until enough samples arrived.
    Overruns drop the oldest samples (real-time semantics) and are
    counted in ``overruns``.
    """

    def __init__(self, port: int, sampling_frequency: float,
                 sample_type: str = "cbyte", iq_swap: bool = False,
                 address: str = "127.0.0.1",
                 buffer_samples: int = 4_000_000):
        if sample_type not in ("cbyte", "cshort", "gr_complex"):
            raise ValueError(f"unsupported sample_type {sample_type!r}")
        self.fs = float(sampling_frequency)
        self._dtype, self._per_sample = ITEM_TYPES[sample_type]
        self._iq_swap = iq_swap
        self._buffer: deque[np.ndarray] = deque()
        self._buffered = 0
        self._max_buffer = buffer_samples
        self.overruns = 0
        self._lock = threading.Condition()
        self._closing = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        frame = self._per_sample * self._dtype.itemsize
        while not self._closing:
            try:
                pkt, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            usable = (len(pkt) // frame) * frame
            if not usable:
                continue
            raw = np.frombuffer(pkt[:usable], dtype=self._dtype)
            samples = _interleaved_to_complex(
                raw, self._per_sample, self._iq_swap)
            with self._lock:
                self._buffer.append(samples)
                self._buffered += len(samples)
                while self._buffered > self._max_buffer and \
                        len(self._buffer) > 1:
                    dropped = self._buffer.popleft()
                    self._buffered -= len(dropped)
                    self.overruns += 1
                self._lock.notify_all()

    def read_block(self, n_samples: int, timeout: float = 10.0
                   ) -> np.ndarray:
        """Block until ``n_samples`` samples arrive, then return them."""
        out = np.empty(n_samples, dtype=np.complex64)
        got = 0
        with self._lock:
            while got < n_samples:
                if not self._buffer:
                    if not self._lock.wait(timeout):
                        raise TimeoutError(
                            f"UDP source: {got}/{n_samples} samples after "
                            f"{timeout}s")
                    continue
                chunk = self._buffer.popleft()
                take = min(len(chunk), n_samples - got)
                out[got: got + take] = chunk[:take]
                got += take
                if take < len(chunk):
                    self._buffer.appendleft(chunk[take:])
                self._buffered -= take
        return out

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        finally:
            self._thread.join(timeout=1.0)


@dataclass
class TimeTag:
    """Absolute GNSS time pinned to a sample index
    (libs/gnss_sdr_timestamp.h)."""

    sample_count: int
    week: int
    tow_ms: float


class FileTimestampSignalSource(FileSignalSource):
    """File source with a binary timetag sidecar.

    Sidecar records are packed little-endian
    ``(uint64 sample_count, int32 week, int32 tow_ms)``
    (gnss_sdr_timestamp.cc:53-63); ``timestamp_clock_offset_ms`` shifts
    every tag (file_timestamp_signal_source.cc:30). ``timetag_for_sample``
    returns the week/TOW at an arbitrary sample index by propagating the
    most recent tag at the sampling rate.
    """

    def __init__(self, filename, timestamp_filename,
                 sampling_frequency: float,
                 item_type: str = "ishort",
                 timestamp_clock_offset_ms: float = 0.0,
                 **kwargs):
        super().__init__(filename, sampling_frequency,
                         item_type=item_type, **kwargs)
        raw = np.fromfile(timestamp_filename, dtype=np.uint8)
        rec = np.dtype([("count", "<u8"), ("week", "<i4"), ("tow", "<i4")])
        n_rec = len(raw) // rec.itemsize
        table = np.frombuffer(
            raw[: n_rec * rec.itemsize].tobytes(), dtype=rec)
        self.timetags = [
            TimeTag(int(r["count"]), int(r["week"]),
                    float(r["tow"]) + timestamp_clock_offset_ms)
            for r in table]
        if not self.timetags:
            raise ValueError(f"{timestamp_filename}: no timetag records")

    def timetag_for_sample(self, sample_index: int) -> TimeTag:
        """Week/TOW at ``sample_index`` from the latest tag at or before
        it (tags are exact; between tags time advances at fs)."""
        tag = self.timetags[0]
        for t in self.timetags:
            if t.sample_count <= sample_index:
                tag = t
            else:
                break
        dt_ms = (sample_index - tag.sample_count) / self.fs * 1e3
        tow = tag.tow_ms + dt_ms
        week = tag.week
        week_ms = 604_800_000.0
        while tow >= week_ms:
            tow -= week_ms
            week += 1
        return TimeTag(sample_index, week, tow)


class ZmqSignalSource:
    """ZeroMQ SUB stream of raw IF samples (ZMQ_Signal_Source,
    /root/reference/src/algorithms/signal_source/adapters/
    zmq_signal_source.cc): connect-or-bind a SUB/PULL socket and stream
    complex64 blocks. ``item_type`` follows the file-source conventions
    (gr_complex, ishort, ibyte)."""

    def __init__(self, endpoint: str, sampling_frequency: float,
                 item_type: str = "gr_complex", bind: bool = False,
                 pull: bool = False, timeout_ms: int = 10_000):
        import zmq

        self._zmq = zmq
        self.fs = float(sampling_frequency)
        self.item_type = item_type
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PULL if pull else zmq.SUB)
        if not pull:
            self.sock.setsockopt(zmq.SUBSCRIBE, b"")
        self.sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        if bind:
            self.sock.bind(endpoint)
        else:
            self.sock.connect(endpoint)
        self._buf = np.zeros(0, dtype=np.complex64)

    def read_block(self, n_samples: int) -> np.ndarray:
        while len(self._buf) < n_samples:
            raw = self.sock.recv()
            if self.item_type == "gr_complex":
                x = np.frombuffer(raw, dtype=np.complex64)
            elif self.item_type == "ishort":
                x = _interleaved_to_complex(
                    np.frombuffer(raw, dtype=np.int16), 2, np.complex64)
            elif self.item_type == "ibyte":
                x = _interleaved_to_complex(
                    np.frombuffer(raw, dtype=np.int8), 2, np.complex64)
            else:
                raise ValueError(f"unsupported item_type {self.item_type}")
            self._buf = np.concatenate([self._buf, x])
        out = self._buf[:n_samples]
        self._buf = self._buf[n_samples:]
        return out

    def close(self) -> None:
        self.sock.close(0)
