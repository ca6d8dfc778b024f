"""Named pipes between the harness and the program: one writer thread a
FASTQ segment that replays the rendered pool until told to stop, and one
drain thread that counts the SAM records coming out, stamps the window
and keeps the bytes of the records the comparison reads.

The writers and the drain only copy and count bytes rendered
beforehand; they run in the harness's process, outside the program's.
"""

from __future__ import annotations

import fcntl
import os
import termios
import threading
import time

import numpy as np

F_SETPIPE_SZ = 1031
PIPE_BYTES = 1 << 20
#: blank lines written first: a reader that opens the file once to sniff
#: its format and again to read it (the program's native FASTQ reader
#: does) loses them; one that reads straight on skips them as blank
SNIFF_PREFIX = b"\n" * 64


def _grow(fd: int):
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_BYTES)
    except OSError:
        pass


def _unread(fd: int) -> int:
    buf = bytearray(4)
    fcntl.ioctl(fd, termios.FIONREAD, buf)
    return int.from_bytes(buf, "little")


class Feeder:
    """Replays the pool into one FIFO a segment: batch j of a segment is
    ``stream.records(j, segment)``. ``stop()`` makes every writer end
    after the same whole batch."""

    def __init__(self, paths: list[str], stream):
        self.paths = paths
        self.stream = stream
        self.started = [0] * len(paths)
        self.stop_at: int | None = None
        self.minimum = 0
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self._abort = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, args=(s,), daemon=True) for s in range(len(paths))
        ]

    def start(self):
        for thread in self._threads:
            thread.start()

    def stop(self) -> int:
        """End every stream after the same batch; returns the batches sent."""
        with self._lock:
            if self.stop_at is None:
                self.stop_at = max(max(self.started), self.minimum)
            return self.stop_at

    def abort(self):
        """Unblock and end the writers at once (the program has failed)."""
        self._abort.set()
        for path in self.paths:
            try:
                os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))
            except OSError:
                pass

    def join(self, timeout: float):
        deadline = time.monotonic() + timeout
        for thread in self._threads:
            thread.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

    def _run(self, segment: int):
        try:
            fd = os.open(self.paths[segment], os.O_WRONLY)
        except OSError as error:
            self.errors.append(f"open {segment}: {error}")
            return
        try:
            if self._abort.is_set():
                return
            _grow(fd)
            self._write(fd, SNIFF_PREFIX)
            while _unread(fd) and not self._abort.is_set():
                time.sleep(0.001)
            j = 0
            while not self._abort.is_set():
                with self._lock:
                    if self.stop_at is not None and j >= self.stop_at:
                        break
                    self.started[segment] = max(self.started[segment], j + 1)
                rows = self.stream.records(j, segment)
                self._write(fd, memoryview(rows).cast("B"))
                j += 1
        except OSError as error:
            if not self._abort.is_set():
                self.errors.append(f"write {segment}: {error}")
        finally:
            os.close(fd)

    def _write(self, fd: int, data):
        view = memoryview(data)
        broken_since = None
        while len(view) and not self._abort.is_set():
            try:
                view = view[os.write(fd, view):]
                broken_since = None
            except BrokenPipeError:
                # between a sniffing reader's close and its second open
                now = time.monotonic()
                broken_since = broken_since or now
                if now - broken_since > 10.0:
                    raise
                time.sleep(0.001)


class Drain:
    """Reads the program's SAM output. The window opens when the records
    of the first `warmup` batches are out, and closes at the first batch
    boundary at least `seconds` later; ``on_open`` and ``on_close`` run in
    this thread at those instants. Keeps the bytes of records
    [capture_from, capture_from + capture_count)."""

    def __init__(self, path: str, batch: int, warmup: int, seconds: float,
                 capture_from: int, capture_count: int, on_open, on_close):
        self.path = path
        self.batch = batch
        self.warmup = warmup
        self.seconds = seconds
        self.capture = (capture_from, capture_from + capture_count)
        self.on_open = on_open
        self.on_close = on_close
        self.header = bytearray()
        self.records = 0
        self.first_record: float | None = None
        self.opened: float | None = None
        self.opened_at = 0  # batches out when the window opened
        self.closed: float | None = None
        self.window_records = 0
        self.batch_times: list[float] = []
        self.kept: list[bytes] = []
        self.error: str | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def poke(self):
        """Unblock a drain still waiting for the program to open its output."""
        try:
            os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
        except OSError:
            pass

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _run(self):
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except OSError as error:
            self.error = f"open output: {error}"
            return
        try:
            _grow(fd)
            in_header = True
            while True:
                chunk = os.read(fd, PIPE_BYTES)
                if not chunk:
                    break
                if in_header:
                    self.header += chunk
                    at = 0
                    while at < len(self.header) and self.header[at:at + 1] == b"@":
                        end = self.header.find(b"\n", at)
                        if end < 0:
                            break
                        at = end + 1
                    if at >= len(self.header) or self.header[at:at + 1] == b"@":
                        continue
                    chunk = bytes(self.header[at:])
                    del self.header[at:]
                    in_header = False
                    self.first_record = time.perf_counter()
                self._records(chunk, time.perf_counter())
        except OSError as error:
            self.error = f"read output: {error}"
        finally:
            os.close(fd)

    def _records(self, chunk: bytes, now: float):
        before = self.records
        after = before + chunk.count(b"\n")
        self.records = after
        first, last = self.capture
        if after > first and before < last:
            lines = None
            start = 0
            if before < first:
                lines = np.flatnonzero(np.frombuffer(chunk, dtype=np.uint8) == 10)
                start = int(lines[first - before - 1]) + 1
            end = len(chunk)
            if after > last:
                lines = lines if lines is not None else np.flatnonzero(
                    np.frombuffer(chunk, dtype=np.uint8) == 10)
                end = int(lines[last - before - 1]) + 1
            self.kept.append(chunk[start:end])
        crossed = after // self.batch - before // self.batch
        if not crossed:
            return
        self.batch_times.extend([now] * crossed)
        done = after // self.batch
        if self.opened is None and done >= self.warmup:
            self.opened = now
            self.opened_at = done
            self.on_open(now)
        elif self.opened is not None and self.closed is None and now - self.opened >= self.seconds:
            self.closed = now
            self.window_records = (done - self.opened_at) * self.batch
            self.on_close(now)
