"""The reduction of a torch.profiler trace to what the per-layer metrics
read.

The trace is the profiler's Chrome trace (``export_chrome_trace``): host
ranges (``cpu_op``, ``user_annotation``: the benchmark's spans and the
program's operators, the autograd nodes included), the launches
(``cuda_runtime``, ``cuda_driver``) and the device's activity (``kernel``,
``gpu_memcpy``, ``gpu_memset``), a launch tied to its activity by its
correlation id.  A span's device time is the activity launched from its
thread while it was open, so the rasterizer's autograd node, which runs on
the backward's thread, counts its own launches.  Times in the trace are in
microseconds on one clock for host and device.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
STEP_SPAN = 'bench.step'


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One traced window: ``steps`` spans named ``bench.step`` and the
    device activity from the first step's start on."""

    def __init__(self, path):
        with open(path) as fh:
            events = [e for e in json.load(fh)['traceEvents'] if e.get('ph') == 'X']
        self.device = [e for e in events if e.get('cat') in DEVICE_CATS]
        self.host = [e for e in events if e.get('cat') in HOST_CATS]
        self.steps = sorted((e for e in self.host if e['name'] == STEP_SPAN
                             and e.get('cat') == 'user_annotation'), key=lambda e: e['ts'])
        if not self.steps:
            raise ValueError(f'no {STEP_SPAN!r} span in the trace')
        self.t0 = self.steps[0]['ts']
        self.device = [e for e in self.device if e['ts'] >= self.t0]
        if not self.device:
            raise ValueError('the trace holds no device activity in its window')
        self.t1 = max(max(e['ts'] + e['dur'] for e in self.device),
                      max(e['ts'] + e['dur'] for e in self.steps))
        by_corr = defaultdict(list)
        for e in self.device:
            c = e.get('args', {}).get('correlation')
            if c is not None:
                by_corr[c].append(e)
        # launches per (pid, tid), sorted by time, with their device us
        self.launches = defaultdict(list)
        for e in self.host:
            if e.get('cat') in LAUNCH_CATS:
                c = e.get('args', {}).get('correlation')
                if c in by_corr:
                    self.launches[(e['pid'], e['tid'])].append(
                        (e['ts'], sum(d['dur'] for d in by_corr[c]), len(by_corr[c])))
        for v in self.launches.values():
            v.sort()
        self.main = (self.steps[0]['pid'], self.steps[0]['tid'])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        return _merge([e['ts'], e['ts'] + e['dur']] for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def activities(self) -> int:
        """Kernels, copies and fills the device ran in the window."""
        return len(self.device)

    def span_device_s(self, pattern: str) -> tuple[float, int]:
        """(device seconds launched inside the host ranges whose name
        matches ``pattern`` in full, number of such ranges); nested ranges
        of one name count once."""
        rx = re.compile(pattern)
        spans = sorted((e for e in self.host if e.get('cat') in ('cpu_op', 'user_annotation')
                        and rx.fullmatch(e['name']) and e['ts'] >= self.t0),
                       key=lambda e: e['ts'])
        total, n, end = 0.0, 0, {}
        for s in spans:
            key = (s['pid'], s['tid'])
            if s['ts'] < end.get(key, -1.0):
                continue                      # inside a range already counted
            end[key] = s['ts'] + s['dur']
            n += 1
            lst = self.launches.get(key, [])
            i = bisect.bisect_left(lst, (s['ts'],))
            while i < len(lst) and lst[i][0] <= s['ts'] + s['dur']:
                total += lst[i][1]
                i += 1
        return total / 1e6, n

    def top_device_ops(self, n: int = 10):
        """[name, seconds] of the device activities that took most time."""
        by = defaultdict(float)
        for e in self.device:
            by[e['name']] += e['dur'] / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[what the host was doing, seconds]: the device's idle time in the
        window, by the innermost host range open on the stepping thread
        when each idle stretch began, the largest first."""
        busy = self.busy_intervals()
        gaps, cur = [], self.t0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        host = sorted((e for e in self.host if (e['pid'], e['tid']) == self.main),
                      key=lambda e: e['ts'])
        starts = [e['ts'] for e in host]
        by = defaultdict(float)
        for g0, g1 in gaps:
            label = 'nothing'
            i = bisect.bisect_right(starts, g0)
            for e in reversed(host[max(0, i - 400):i]):
                if e['ts'] + e['dur'] > g0:
                    label = e['name']
                    break
            by[label[:120]] += (g1 - g0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
