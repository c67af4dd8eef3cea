"""Device activity of a traced window, read from torch.profiler's trace.

The window's fits run back to back under the profiler, which traces the
device's operations (kernels, copies, sets) and the CUDA runtime's calls on
the host.  Busy time is the union of the device's intervals; the window is
the fits' summed wall time on the host's clock; an idle gap between two
device operations is named by the innermost host call running at its
middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

#: gaps shorter than this (seconds) are summed under one name
MIN_GAP = 20e-6

#: host calls looked back through for those running at a gap
SCAN = 200


class Activity:
    """The device's operations and the host's calls, each (name, start,
    end) in seconds on the profiler's clock, over `n_fits` fits of
    `window_s` wall seconds."""

    def __init__(self, device, host, window_s: float, n_fits: int):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self.window_s, self.n_fits = window_s, n_fits

    @staticmethod
    def from_profiler(prof, window_s: float, n_fits: int):
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            t0 = e.start_ns() * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
            (device if e.device_type() == DeviceType.CUDA else host).append(
                (e.name(), t0, t1))
        return Activity(device, host, window_s, n_fits)

    def busy(self):
        """(busy seconds, idle gaps [(start, length)] between the device's
        operations)."""
        busy, gaps, edge = 0.0, [], None
        for _, t0, t1 in self.device:
            if edge is not None and t0 > edge:
                gaps.append((edge, t0 - edge))
            if edge is None or t1 > edge:
                busy += t1 - (t0 if edge is None else max(t0, edge))
                edge = t1
        return busy, gaps

    def device_seconds(self, match) -> float:
        """Summed device time of the operations whose name contains one
        of `match`."""
        return sum(t1 - t0 for name, t0, t1 in self.device
                   if any(m in name for m in match))

    def top_ops(self, k=10):
        tot = defaultdict(float)
        for name, t0, t1 in self.device:
            tot[name] += t1 - t0
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def top_gaps(self, k=10):
        """The idle time by what the host was doing: the innermost host
        call running at each gap's middle, largest first; gaps under
        MIN_GAP together."""
        starts = [t0 for _, t0, _ in self.host]
        tot = defaultdict(float)
        for t, length in self.busy()[1]:
            if length < MIN_GAP:
                tot["(gaps under 20 us)"] += length
                continue
            mid = t + 0.5 * length
            name, best = "(host between calls)", None
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - SCAN, -1), -1):
                op, t0, t1 = self.host[j]
                if t1 >= mid and (best is None or t1 - t0 < best):
                    name, best = op, t1 - t0
            tot[name] += length
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]
