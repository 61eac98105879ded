"""What a torch.profiler trace of whole jobs says about the device: busy
time, idle share, kernel counts and times by name, and where the idle time
falls on the host.

The arithmetic is the benchmark's own, frozen here: the device is busy in
the union of the intervals of its operations (kernels, copies, sets), and
idle for the rest of the traced window, which is the host's time from the
first job's start to the last traced job's synchronised end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# device operations that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")
# a name in the breakdown is cut to this many characters
NAME_CHARS = 120


class Trace:
    """Device and host operations of one traced window (nanoseconds on the
    profiler's clock)."""

    def __init__(self, dev, host, window_s: float):
        self.dev_name, self.dev_start, self.dev_end = dev
        (self.host_name, self.host_start, self.host_end,
         self.host_thread) = host
        self.window_s = window_s
        self._merged = merge(self.dev_start, self.dev_end)

    @property
    def busy_s(self) -> float:
        s, e = self._merged
        return float((e - s).sum()) * 1e-9

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, holding: str | None = None) -> np.ndarray:
        """Durations (s) of the device kernels, or of those whose name holds
        ``holding``."""
        keep = [i for i, n in enumerate(self.dev_name)
                if not n.startswith(NOT_KERNELS)
                and (holding is None or holding in n)]
        return (self.dev_end[keep] - self.dev_start[keep]) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time,
        summed by name."""
        sums: dict[str, float] = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            sums[n] = sums.get(n, 0.0) + float(e - s) * 1e-9
        return [[n[:NAME_CHARS], v] for n, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds]: the device's idle gaps (between the union's
        intervals) summed by what the host was doing at each gap's middle:
        the outermost host operation under way then, or "between host
        operations"; the largest sums first."""
        s, e = self._merged
        if len(s) < 2:
            return []
        mid = (e[:-1] + s[1:]) // 2
        length = (s[1:] - e[:-1]) * 1e-9
        ts, te, names = self._outermost()
        j = np.searchsorted(ts, mid, side="right") - 1
        inside = (j >= 0) & (te[np.maximum(j, 0)] >= mid)
        label = np.where(inside, j, -1)
        sums: dict[str, float] = {}
        for k, v in zip(*_sum_by(label, length)):
            name = names[k] if k >= 0 else "between host operations"
            sums[name] = sums.get(name, 0.0) + v
        return [[n[:NAME_CHARS], v] for n, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def _outermost(self):
        """The operations of the host thread that ran the program's ops
        (the one with the most ``aten::`` records) that no other one holds:
        (starts, ends, names), sorted and disjoint."""
        aten = [t for n, t in zip(self.host_name, self.host_thread)
                if n.startswith("aten::")]
        ids, counts = np.unique(np.asarray(aten or self.host_thread,
                                           dtype=np.int64),
                                return_counts=True)
        mine = np.nonzero(self.host_thread == ids[np.argmax(counts)])[0]
        o = mine[np.argsort(self.host_start[mine], kind="stable")]
        hs, he = self.host_start[o], self.host_end[o]
        reach = np.maximum.accumulate(he)
        top = np.ones(len(hs), dtype=bool)
        top[1:] = hs[1:] >= reach[:-1]
        keep = o[top]
        return (self.host_start[keep], self.host_end[keep],
                [self.host_name[i] for i in keep])


def _sum_by(keys: np.ndarray, values: np.ndarray):
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq.tolist(), np.bincount(inv, weights=values).tolist()


def merge(start: np.ndarray, end: np.ndarray):
    """The union of intervals, as sorted disjoint (start, end) arrays."""
    if len(start) == 0:
        return start, end
    o = np.argsort(start, kind="stable")
    s, e = start[o], end[o]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    return s[idx], ends


def _columns(events):
    """Device columns (names, starts, ends) and host columns (names,
    starts, ends, threads) of the profiler's events, in one pass."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = ([], [], []), ([], [], [], [])
    for ev in events:
        on_dev = ev.device_type() == cuda
        cols = dev if on_dev else host
        cols[0].append(ev.name())
        cols[1].append(ev.start_ns())
        cols[2].append(ev.end_ns())
        if not on_dev:
            cols[3].append(ev.start_thread_id())
    return ((dev[0],) + tuple(np.asarray(c, dtype=np.int64)
                              for c in dev[1:]),
            (host[0],) + tuple(np.asarray(c, dtype=np.int64)
                               for c in host[1:]))


def capture(fn):
    """Run ``fn`` under torch.profiler (host and device activity) and return
    (fn's result, its Trace).  The window is the host's clock around ``fn``
    and a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = _columns(prof.profiler.kineto_results.events())
    return out, Trace(dev, host, window_s)
