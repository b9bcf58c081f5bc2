"""A torch.profiler window read from its Chrome trace: host ranges
(record_function), host operators, device activity (kernels, copies,
sets) and which host range launched each device operation.

Times are seconds on the trace's clock. Interval helpers take (n, 2)
arrays of [start, end] and never sum overlapping time twice.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(iv) -> np.ndarray:
    """The disjoint union of intervals iv (n, 2), sorted."""
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def length(iv) -> float:
    u = union(iv)
    return float(np.sum(u[:, 1] - u[:, 0])) if len(u) else 0.0


def clip(iv, lo: float, hi: float) -> np.ndarray:
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    iv = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return iv[iv[:, 1] > iv[:, 0]]


def intersect(a, b) -> np.ndarray:
    """The union of a intersected with the union of b."""
    a, b = union(a), union(b)
    out = []
    for s, e in b:
        out.append(clip(a, s, e))
    return union(np.concatenate(out)) if out else np.zeros((0, 2))


def contains(iv, t) -> np.ndarray:
    """For each time in t, whether some interval of iv holds it."""
    u = union(iv)
    t = np.asarray(t, dtype=np.float64)
    if not len(u):
        return np.zeros(t.shape, dtype=bool)
    i = np.searchsorted(u[:, 0], t, side="right") - 1
    ok = i >= 0
    ok[ok] = t[ok] <= u[i[ok], 1]
    return ok


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges = defaultdict(list)
        ops, dev, dev_names, dev_corr = [], [], [], []
        launch = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts = float(ev["ts"]) * 1e-6
            iv = (ts, ts + float(ev.get("dur", 0.0)) * 1e-6)
            if cat == "user_annotation":
                ranges[ev["name"]].append(iv)
            elif cat == "cpu_op":
                ops.append((iv[0], iv[1], ev["name"]))
            elif cat in DEVICE_CATS:
                dev.append(iv)
                dev_names.append(ev["name"])
                dev_corr.append(ev.get("args", {}).get("correlation", -1))
            elif cat in LAUNCH_CATS:
                c = ev.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = iv[0]
        self.ranges = {k: np.asarray(v) for k, v in ranges.items()}
        self.ops = sorted(ops)
        self.device = np.asarray(dev, dtype=np.float64).reshape(-1, 2)
        self.device_names = dev_names
        self.launch_t = np.asarray([launch.get(c, np.nan) for c in dev_corr],
                                   dtype=np.float64)

    def range(self, *names) -> np.ndarray:
        """Every interval of the host ranges `names`, (n, 2)."""
        got = [self.ranges[n] for n in names if n in self.ranges]
        return np.concatenate(got) if got else np.zeros((0, 2))

    def prefixed(self, prefix: str) -> np.ndarray:
        return self.range(*[n for n in self.ranges if n.startswith(prefix)])

    def window(self):
        w = self.range("portbench::window")
        return float(w[0, 0]), float(w[0, 1])

    def busy(self) -> np.ndarray:
        """Device activity inside the window, as a disjoint union."""
        return union(clip(self.device, *self.window()))

    def launched_in(self, *names) -> np.ndarray:
        """Device intervals of the operations whose launch call ran inside
        the host ranges `names`."""
        inside = contains(self.range(*names), self.launch_t)
        return self.device[inside]

    def unmatched_launches(self) -> int:
        return int(np.sum(np.isnan(self.launch_t)))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time inside the window summed by what the host was in: the
        innermost range, then the innermost operator, over each stretch
        of idle time."""
        lo, hi = self.window()
        per = defaultdict(float)
        for (s, e), n in zip(self.device, self.device_names):
            per[n[:64]] += e - s
        ops = sorted(per.items(), key=lambda x: -x[1])[:top]
        ranges = [(n, s, e) for n, iv in self.ranges.items()
                  if n != "portbench::window" for s, e in iv]
        busy = self.busy()
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        cuts = np.unique(np.clip(np.concatenate(
            [[lo, hi], gaps.ravel()] + [[s, e] for _, s, e in ranges]),
            lo, hi))
        mid = (cuts[:-1] + cuts[1:]) / 2
        idle = contains(gaps, mid) & ~contains(busy, mid)
        mid, width = mid[idle], np.diff(cuts)[idle]
        label = np.full(len(mid), "", dtype=object)
        span = np.full(len(mid), np.inf)
        for name, s, e in ranges:                  # mid is sorted
            a, b = np.searchsorted(mid, [s, e], side="left")
            hit = span[a:b] > e - s
            label[a:b][hit] = name
            span[a:b][hit] = e - s
        starts = np.asarray([o[0] for o in self.ops])
        if len(starts):
            i = np.searchsorted(starts, mid, side="right") - 1
            for g in np.flatnonzero(i >= 0):
                s, e, n = self.ops[i[g]]
                if e >= mid[g]:
                    label[g] = f"{label[g]} / {n}" if label[g] else n
        sums = defaultdict(float)
        for lab, w in zip(label, width):
            sums[lab or "no_host_range"] += w
        gaps_top = sorted(sums.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, float(t)] for n, t in ops],
                "idle_gaps": [[n, float(t)] for n, t in gaps_top]}
