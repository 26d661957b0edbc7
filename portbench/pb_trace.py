"""The device trace of a traced run and the harness's own host spans.

``Spans`` times the calls into the service's layers from outside
(``begin_call``, ``decode_step_batch``, ``finish_call``), on the host's
``perf_counter``.  ``DeviceTrace`` runs ``torch.profiler`` over the
window, CUDA activity only, and reads every device operation (kernels,
copies, sets) back with its start and duration.  One ``spin_kernel``
launched right after a synchronize at the start maps the device's
clock onto the host's, to within a launch (microseconds), so that each
idle gap of the device can be named by the host span it fell in.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    info: Dict = field(default_factory=dict)


class Spans:
    """Host spans around the service's entry points (installed on one
    service instance; nothing of the program is edited)."""

    def __init__(self, svc, io_read, observer=None):
        self.svc = svc
        self.io_read = io_read
        self.observer = observer
        self.items: List[Span] = []
        self._orig = {}
        for name in ("begin_call", "decode_step_batch", "finish_call"):
            self._orig[name] = getattr(svc, name)
            setattr(svc, name, getattr(self, "_" + name))

    def remove(self):
        for name, fn in self._orig.items():
            setattr(self.svc, name, fn)

    def _begin_call(self, stub, request):
        ctx = self.svc.contexts[stub.ctx_id]
        n0, r0 = ctx.n_tokens, self.io_read()
        if self.observer is not None:
            self.observer.begin(stub.ctx_id)
        t0 = time.perf_counter()
        try:
            return self._orig["begin_call"](stub, request)
        finally:
            self.items.append(Span("begin_call", t0, time.perf_counter(), {
                "req": id(request), "n0": n0, "M": len(request.prompt),
                "read": self.io_read() - r0}))

    def _decode_step_batch(self, sts):
        # the positions of the tokens this round feeds through the model
        # (a generation's last token is emitted, never fed)
        pos = [st.ctx.n_tokens for st in sts
               if not st.done and st.next_tok is not None
               and len(st.generated) + 1 < st.request.max_new_tokens]
        t0 = time.perf_counter()
        try:
            return self._orig["decode_step_batch"](sts)
        finally:
            self.items.append(Span("decode_round", t0, time.perf_counter(),
                                   {"pos": pos}))

    def _finish_call(self, st):
        t0 = time.perf_counter()
        try:
            return self._orig["finish_call"](st)
        finally:
            self.items.append(Span("finish_call", t0, time.perf_counter()))

    def within(self, name: str, t0: float, t1: float) -> List[Span]:
        return [s for s in self.items
                if s.name == name and s.t0 >= t0 and s.t1 <= t1]


def _ns(ev, what: str) -> float:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, what + "_us")()) * 1e3


@dataclass
class Op:
    name: str
    t0: float                       # host clock, s
    dur: float                      # s


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Op] = []
        self.t0 = self.t1 = 0.0

    def start(self):
        torch = self.torch
        self.prof.start()
        torch.cuda.synchronize()
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        evs = [e for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == self.torch.autograd.DeviceType.CUDA]
        spin = min((e for e in evs if "spin_kernel" in e.name()),
                   key=lambda e: _ns(e, "start"))
        off = _ns(spin, "start") * 1e-9 - self._mark
        self.ops = sorted(
            (Op(e.name(), _ns(e, "start") * 1e-9 - off,
                _ns(e, "duration") * 1e-9)
             for e in evs if e is not spin
             and _ns(e, "start") * 1e-9 - off >= self.t0),
            key=lambda o: o.t0)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> Tuple[float, List[Tuple[float, float]]]:
        """(seconds some operation ran, the idle gaps (start, end))."""
        busy, idle = 0.0, []
        cur0 = cur1 = self.t0
        for o in self.ops:
            a, b = max(o.t0, self.t0), min(o.t0 + o.dur, self.t1)
            if b <= a:
                continue
            if a > cur1:
                busy += cur1 - cur0
                idle.append((cur1, a))
                cur0 = a
            cur1 = max(cur1, b)
        busy += cur1 - cur0
        if self.t1 > cur1:
            idle.append((cur1, self.t1))
        return busy, idle

    def by_name(self, pattern: str) -> List[Op]:
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o.name)]


def short(name: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.<>,:-]+", "_", name)[:n]


def breakdown(trace: DeviceTrace, spans: Spans) -> Dict:
    """The device operations that took most time, and the idle gaps
    summed by the host span they fell in, ten each."""
    tot: Dict[str, float] = defaultdict(float)
    for o in trace.ops:
        tot[short(o.name)] += o.dur
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    _, idle = trace.busy()
    host = sorted((s.t0, s.t1, s.name) for s in spans.items
                  if s.t1 >= trace.t0 and s.t0 <= trace.t1)
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in idle:
        mid = 0.5 * (a + b)
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        name = ("router_or_apps" if i < 0 or host[i][1] < mid
                else host[i][2])
        gaps[name] += b - a
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}
