"""The device's side of a traced run: the program's torch.profiler Chrome
trace (``PHENIQS_PROFILE``) cut to the measured window.

The arithmetic is a copy of the program's ``benchmark.trace_summary``
(the union of the card's kernel, copy and memset intervals), taken over
the window only. A trace's timestamps are microseconds after its
``baseTimeNanoseconds`` on the wall clock, which is how the harness
stamps the window too.
"""

from __future__ import annotations

import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


class Window:
    """Device and host events of a trace inside [start, stop] (wall-clock
    seconds), each as (name, start_s, stop_s), clipped to the window."""

    def __init__(self, events: list[dict], base_us: float, start: float, stop: float):
        self.start, self.stop = start, stop
        self.device: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.first_s = self.last_s = None
        for event in events:
            if event.get("ph") != "X":
                continue
            category = event.get("cat")
            begin = (base_us + float(event["ts"])) / 1e6
            end = begin + float(event.get("dur", 0.0)) / 1e6
            if category in DEVICE_CATEGORIES:
                self.first_s = begin if self.first_s is None else min(self.first_s, begin)
                self.last_s = end if self.last_s is None else max(self.last_s, end)
            if end <= start or begin >= stop:
                continue
            item = (event.get("name", "?"), max(begin, start), min(end, stop))
            if category in DEVICE_CATEGORIES:
                self.device.append(item)
            elif category in HOST_CATEGORIES:
                self.host.append(item)
        self.device.sort(key=lambda item: item[1])

    @property
    def window_s(self) -> float:
        return self.stop - self.start

    def covers(self) -> bool:
        """Whether the trace's device events span the whole window."""
        return self.first_s is not None and self.first_s <= self.start and self.last_s >= self.stop

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        busy, end = 0.0, float("-inf")
        for _, begin, stop in self.device:
            busy += max(0.0, stop - max(begin, end))
            end = max(end, stop)
        return busy

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the device inside the window."""
        out, end = [], self.start
        for _, begin, stop in self.device:
            if begin > end:
                out.append((end, begin))
            end = max(end, stop)
        if self.stop > end:
            out.append((end, self.stop))
        return out

    def seconds_by_name(self, match=None) -> dict[str, list]:
        """{name: [launches, seconds]} of the device operations (those whose
        name `match` accepts)."""
        out: dict[str, list] = {}
        for name, begin, stop in self.device:
            if match is None or match(name):
                entry = out.setdefault(name, [0, 0.0])
                entry[0] += 1
                entry[1] += stop - begin
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the longest host event overlapping each."""
        ops = sorted(self.seconds_by_name().items(), key=lambda item: -item[1][1])[:TOP]
        longest = sorted(self.gaps(), key=lambda gap: gap[0] - gap[1])[:TOP]
        named = []
        for begin, stop in longest:
            best, label = 0.0, "host idle"
            for name, h0, h1 in self.host:
                overlap = min(h1, stop) - max(h0, begin)
                if overlap > best:
                    best, label = overlap, name
            named.append([label[:80], stop - begin])
        return {"device_ops": [[name[:80], seconds] for name, (_, seconds) in ops],
                "idle_gaps": named}


def load(directory: str, start: float, stop: float) -> Window | None:
    """The newest trace in `directory`, cut to [start, stop]; None where
    there is none."""
    if not os.path.isdir(directory):
        return None
    traces = [os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".trace.json")]
    if not traces:
        return None
    with open(max(traces, key=os.path.getmtime)) as stream:
        trace = json.load(stream)
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    return Window(trace.get("traceEvents", []), base_us, start, stop)
