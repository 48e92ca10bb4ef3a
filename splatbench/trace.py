"""The traced run's profile: ``torch.profiler`` over a bounded number of
steps, read back from its Chrome trace into device operations, host
events and the benchmark's own spans (``record_function`` names that start
with ``splatbench.``).

The profiled steps start after the device is idle and the host has waited
50 ms inside the profile, since the device's tracing can start late (a
profile of a lone kernel launch has shown no device event).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "splatbench.profiled"
CALL = "splatbench.call"


class Event(NamedTuple):
    name: str
    start: float   # us, the trace's clock
    dur: float     # us


class Profile(NamedTuple):
    device: List[Event]          # device operations in the window
    host: List[Event]            # host events in the window
    window: Tuple[float, float]  # (first call's start, end) us
    steps: int                   # calls profiled

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        return sum(b - a for a, b in merged(self.device)) / 1e6

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Seconds of device operations whose name ``match`` accepts."""
        return sum(e.dur for e in self.device if match(e.name)) / 1e6


def merged(events: List[Event]) -> List[Tuple[float, float]]:
    """The union of the events' intervals as sorted disjoint (start, end)."""
    out: List[List[float]] = []
    for e in sorted(events, key=lambda e: e.start):
        a, b = e.start, e.start + e.dur
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile(step: Callable[[], None], calls: int, device) -> Profile:
    """``step()`` ``calls`` times under the profiler, the window closed by
    a synchronisation."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            time.sleep(0.05)
            for _ in range(calls):
                with torch.profiler.record_function(CALL):
                    step()
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, calls)


def parse(events, calls: int) -> Profile:
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the profile has no window span")
    b = float(win[0]["ts"]) + float(win[0]["dur"])
    starts = [float(e["ts"]) for e in events if e.get("ph") == "X"
              and e.get("name") == CALL and e.get("cat") == "user_annotation"]
    a = min(starts) if starts else float(win[0]["ts"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e["name"], float(e["ts"]), float(e["dur"]))
        if not (a <= ev.start <= b):
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append(ev)
        elif e.get("cat") in HOST_CATS and ev.name not in (WINDOW, CALL):
            host.append(ev)
    return Profile(dev, host, (a, b), calls)


def short(name: str, n: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in ("<", "("):
        if sep in name and name.index(sep) > 0:
            name = name[:name.index(sep)]
    return name[:n]


def breakdown(p: Profile, top: int = 10) -> Optional[dict]:
    """The device operations that took most time and the longest idle
    gaps by the innermost host event under each, in seconds: the
    ``breakdown`` of the result line."""
    if not p.device:
        return None
    by_op = defaultdict(float)
    for e in p.device:
        by_op[short(e.name)] += e.dur / 1e6
    busy = merged(p.device)
    gaps = []
    edge = p.window[0]
    for a, b in busy + [(p.window[1], p.window[1])]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    by_host = defaultdict(float)
    host = sorted(p.host, key=lambda e: e.start)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        under = [e for e in host if e.start <= mid <= e.start + e.dur]
        name = min(under, key=lambda e: e.dur).name if under else "(none)"
        by_host[short(name)] += (b - a) / 1e6
    return {"device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(by_host.items(), key=lambda kv: -kv[1])[:top]}
