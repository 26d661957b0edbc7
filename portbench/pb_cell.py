"""One run of one cell: set-up, the measured window, the traced reading
of the layers, and the comparison that decides ``correct``.

The window drives the port's ``ServiceRouter`` with its dispatcher
thread, one ``AppSession`` per app, through ``AppSession.stream``.  The
apps make a closed loop: each keeps exactly one call outstanding, and
issues its next call the moment its last one completes (think time 0),
from the router's completion hook.  From the window's close no new
call is issued; the calls in flight finish in the drain.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import pb_codec
import pb_judge
import pb_model
import pb_stats
import pb_traffic
from pb_trace import DeviceTrace, Spans, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
HERE = Path(__file__).resolve().parent
DRAIN_S = 120.0
COMPARE_TOKENS = 360            # served tokens the comparison aims at
COMPARE_CONTEXTS = 8            # at most this many contexts compared


class Refused(Exception):
    """The run cannot give a result (exit non-zero, print none)."""


@dataclass
class AppCall:
    app: int
    ctx: int
    stream: object
    t_submit: float
    switch_s: Optional[float] = None
    reissued: bool = False          # a failed call's successor issued


@dataclass
class Run:
    """What the metric readers read (``portbench/metrics/<name>.py``)."""
    cfg: object
    conf: Dict
    geom: object
    calls: List[AppCall]
    spans: Spans
    trace: Optional[DeviceTrace]
    t0: float
    t1: float
    extras: Dict = field(default_factory=dict)

    def roofline(self, name: str):
        return _load(HERE / "rooflines" / f"{name}.py")

    @property
    def peaks(self) -> Dict:
        return json.loads((HERE / "peaks.json").read_text())


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_spec(root: Path, workload: str):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    conf = json.loads((root / conf_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return wl, conf, mix, limits, e2e, per_layer


class Observer:
    """What the service decided for each call, as the slot engine's
    reference needs to follow it: whether the switch-in kept the parked
    slot, which chunks were resident, which missing ones it recomputed
    (its Eq.-4 split), and which chunks the switch-out encoded again.
    Read from outside, on one service instance."""

    def __init__(self, svc):
        self.svc, self.res = svc, svc.res
        self.pending: Dict[int, Dict] = {}
        self._orig = {n: getattr(self.res, n) for n in (
            "switch_in", "_plan_restore", "compress_and_swap_out")}
        self.res.switch_in = self._on_switch_in
        self.res._plan_restore = self._on_plan
        self.res.compress_and_swap_out = self._on_swap_out

    def remove(self):
        for n, fn in self._orig.items():
            setattr(self.res, n, fn)

    def begin(self, cid: int):
        self.pending[cid] = {"fast": True}

    def _on_switch_in(self, ctx, slot=None):
        self.pending[ctx.cid] = {"fast": False, "resident": sorted(
            i for i, m in ctx.chunks.items() if m.in_memory)}
        return self._orig["switch_in"](ctx, slot)

    def _on_plan(self, ctx, missing):
        re_idx, io_idx = self._orig["_plan_restore"](ctx, missing)
        self.pending.setdefault(ctx.cid, {})["recompute"] = list(re_idx)
        return re_idx, io_idx

    def _on_swap_out(self, ctx, cache=None):
        before = dict(ctx.payload)
        out = self._orig["compress_and_swap_out"](ctx, cache)
        self.pending.setdefault(ctx.cid, {})["reencoded"] = sorted(
            i for i, p in ctx.payload.items() if before.get(i) is not p)
        return out

    def take(self, cid: int) -> Dict:
        return self.pending.pop(cid, {})


class Cell:
    """The program under test, set up for one cell."""

    def __init__(self, conf: Dict, mix: Dict, seed: int, device):
        import torch
        from repro_torch.core.restore import io_counters
        from repro_torch.core.scheduler import ServiceRouter
        from repro_torch.core.service import LLMSConfig, LLMService
        from repro_torch.models.registry import build_model

        import pb_ref_dense
        self.torch, self.device = torch, torch.device(device)
        self.io = io_counters
        self.cfg = pb_model.port_config(conf)
        sv = conf["service"]
        self.geom = pb_ref_dense.Geometry.of(sv["chunk_tokens"],
                                             sv["max_ctx_len"])
        self.params = pb_model.make_weights(self.cfg, seed, self.device)
        self.plan = pb_traffic.make_plan(mix, self.cfg.vocab, seed)
        budget = pb_traffic.kv_budget_bytes(
            mix, self.plan, self.cfg.kv_bytes_per_token(2.0))
        self.swap_dir = tempfile.mkdtemp(prefix="portbench_swap_")
        lcfg = LLMSConfig(
            policy=sv["policy"], decode_batch=sv["decode_batch"],
            paged_pool=sv["paged_pool"], chunk_tokens=sv["chunk_tokens"],
            max_ctx_len=sv["max_ctx_len"],
            pool_pages_16=sv.get("pool_pages_16", 0),
            memory_budget=budget, swap_dir=self.swap_dir)
        self.budget = budget
        self.model = build_model(self.cfg, device=self.device)
        self.svc = LLMService(self.model, self.params, lcfg,
                              device=self.device)
        self.router = ServiceRouter(self.svc, start=True,
                                    slice_steps=sv["slice_steps"])
        self.sessions = [self.router.register_app(f"app{a}")
                         for a in range(self.plan.n_apps)]
        self.observer = Observer(self.svc)
        self.spans = Spans(self.svc, lambda: self.io()["read"],
                           self.observer)
        self.records: Dict[int, List[pb_judge.CallRec]] = defaultdict(list)
        self.calls: List[AppCall] = []
        self._by_req: Dict[int, AppCall] = {}
        self._lock = threading.Lock()
        self._next = [0] * self.plan.n_apps
        self.tokens = [len(h) for h in self.plan.histories]
        self.redirects = 0
        self.refused = 0            # calls no context of the app had room for
        self.t_end = math.inf
        self.router.on_complete = self._on_complete
        # a history longer than a call may add (half the working window)
        # goes in as consecutive calls that answer nothing
        half = self.geom.n_slots // 2
        self.stubs = []
        for c, hist in enumerate(self.plan.histories):
            sess = self.sessions[self.plan.ctx_app[c]]
            pieces = [hist[i:i + half] for i in range(0, len(hist), half)]
            stub = self.router.new_ctx(sess, system_prompt=pieces[0].tolist())
            for p in pieces[1:]:
                sess.stream(stub, p.tolist(), max_new_tokens=0).result()
            self.stubs.append(stub)
        self.svc.swapper.flush()
        self.written_setup = self.io()["write"]
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the closed loop ------------------------------------------------ #
    def _on_complete(self, job, cancelled):
        cid = job["stub"].ctx_id
        ctx = self.svc.contexts[cid]
        first = not self.records[cid]
        self.records[cid].append(pb_judge.CallRec(
            prompt=np.asarray(job["request"].prompt, np.int64),
            served=list(job["stream"].tokens),
            bits={i: int(m.bits) for i, m in ctx.chunks.items()},
            obs=self.observer.take(cid),
            history=dict(ctx.payload),
            density=pb_codec.chunk_density(
                ctx.density_sum, ctx.density_cnt, ctx.n_tokens,
                self.geom.cs) if first else None))
        call = self._by_req.get(id(job["request"]))
        if call is not None:
            self.records[cid][-1].in_window = True
            rec = self.svc.records[-1] if self.svc.records else {}
            call.switch_s = float(rec.get("switch_s", 0.0))
            if time.perf_counter() < self.t_end:
                self.issue(call.app)

    def issue(self, a: int):
        """App ``a``'s next call, to its planned context or, if that one
        could overflow the working window, to its emptiest one.  Where
        none of the app's contexts has room, the call is refused and the
        app leaves the loop: the run counts it, and a refused call makes
        the run not correct (the mix is sized so that none is)."""
        with self._lock:
            k = self._next[a]
            if k >= len(self.plan.calls[a]):
                return
            self._next[a] = k + 1
            call = self.plan.calls[a][k]
            need = len(call.prompt) + call.max_new
            c = call.ctx
            lim = self.geom.n_slots
            if self.tokens[c] + need > lim:
                own = [x for x, o in enumerate(self.plan.ctx_app) if o == a]
                c = min(own, key=lambda x: self.tokens[x])
                self.redirects += 1
                if self.tokens[c] + need > lim:
                    self.refused += 1
                    return
            self.tokens[c] += need
            stream = self.sessions[a].stream(self.stubs[c],
                                             call.prompt.tolist(),
                                             max_new_tokens=call.max_new)
            ac = AppCall(a, c, stream, stream.t_submit)
            self._by_req[id(stream.request)] = ac
            self.calls.append(ac)

    def window(self, seconds: float, trace: Optional[DeviceTrace]):
        """The measured window, then the drain."""
        self.w_read0 = self.io()["read"]
        self.w_write0 = self.io()["write"]
        self.router.reset_stats()
        if trace is not None:
            trace.start()
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds
        for a in range(self.plan.n_apps):
            self.issue(a)
        while time.perf_counter() < self.t_end:
            time.sleep(min(0.05, max(0.0, self.t_end - time.perf_counter())))
            self._reissue_failed()
        deadline = self.t_end + DRAIN_S
        while time.perf_counter() < deadline:
            if all(c.stream.done for c in list(self.calls)):
                break
            time.sleep(0.01)
        if all(c.stream.done for c in self.calls):
            self.router.drain()
        if trace is not None:
            trace.stop()
        self.t_drained = time.perf_counter()
        self.w_read = self.io()["read"] - self.w_read0
        self.w_written = self.io()["write"] - self.w_write0

    def _reissue_failed(self):
        """An app whose call failed issues its next one (no completion
        hook runs for a failed call)."""
        for c in list(self.calls):
            if c.stream.done and c.stream.error is not None \
                    and not c.reissued:
                c.reissued = True
                self.issue(c.app)

    def close(self):
        """Stop the program and let its device state go (the weights,
        the benchmark's inputs, stay for the reference)."""
        self.spans.remove()
        self.observer.remove()
        try:
            self.router.shutdown()
        finally:
            self.svc.close()
            shutil.rmtree(self.swap_dir, ignore_errors=True)
            self.spans.svc = self.observer.svc = self.observer.res = None
            self.router = self.svc = self.model = self.sessions = None


# ---------------------------------------------------------------------- #
def ttfts(cell: Cell) -> List[float]:
    """Issue -> first token at the app, ms, of every call issued in the
    window; +inf for one that failed, never finished or was refused."""
    out = []
    for c in cell.calls:
        s = c.stream
        ok = s.done and s.error is None and s.t_first_token is not None
        out.append((s.t_first_token - c.t_submit) * 1e3 if ok else math.inf)
    return out + [math.inf] * cell.refused


def end_to_end(cell: Cell, setup_s: float) -> Dict:
    stamps = [t for c in cell.calls for t in c.stream.token_times]
    return {"tokens_per_s": pb_stats.rate(stamps, cell.t0, cell.t_end),
            "setup_s": setup_s}


def sample_contexts(cell: Cell, seed: int) -> List[int]:
    """The contexts compared: the one that served the window's longest
    call, then others in an order drawn from the seed, until about
    COMPARE_TOKENS served tokens are covered."""
    served = defaultdict(int)
    longest = (-1, None)
    for cid, recs in cell.records.items():
        for r in recs:
            if r.in_window:
                served[cid] += len(r.served)
                if len(r.served) > longest[0]:
                    longest = (len(r.served), cid)
    if longest[1] is None:
        return []
    rng = np.random.default_rng([seed, 7])
    rest = [c for c in sorted(served) if c != longest[1]]
    order = [longest[1]] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for c in order:
        out.append(c)
        n += served[c]
        if n >= COMPARE_TOKENS or len(out) >= COMPARE_CONTEXTS:
            break
    return out


def reference(cfg, params, geom, precision="fp32"):
    """The plain reference of ``cfg``'s family."""
    if cfg.family == "dense":
        import pb_ref_dense
        return pb_ref_dense.DenseReference(cfg, params, geom, precision)
    import pb_ref_mla
    return pb_ref_mla.MLAReference(cfg, params, geom, precision)


def replay(ref, recs):
    """One context's calls through ``ref``. -> (its context, the logits
    of each call, its chunk densities after the first call).

    A dense context's calls are teacher-forced on the program's encoded
    history: each call after the first attends the history as the
    program left it at the last switch-out (its codes and scales), and
    computes the call itself in the reference's arithmetic.  A 2-bit
    code sits next to a rounding boundary often enough that bf16's
    rounding flips some, and at the published width random attention is
    sharp enough that a flipped key moves the next layers' inputs: two
    sound computations that each encode their own history part within a
    few calls.  So the encoding is judged by itself (``code_dev``,
    ``scale_dev``: the program's codes against the reference's encoding
    of the same chunk) and the model's arithmetic over one history
    (``max_gap_sigma``)."""
    rc, logits, first = ref.new_context(), [], None
    dense = ref.cfg.family == "dense"
    for j, rec in enumerate(recs):
        if dense:
            if j:
                ref.load_history(rc, pb_judge.history_values(
                    recs[j - 1].history))
            logits.append(ref.call(rc, rec.prompt, rec.served).logits)
            ref.switch_out(rc, rec.bits)
        else:
            logits.append(ref.call(rc, rec.prompt, rec.served,
                                   rec.obs).logits)
            ref.switch_out(rc, rec.bits, rec.obs)
        if first is None:
            first = ref.density(rc)
    return rc, logits, first


def compare(cfg, params, geom, records, subjects, precision="fp32",
            also=None):
    """Replay each sampled context through the reference and read the
    subjects against it.  -> (Readings, {precision: Readings} of the
    replays in ``also``, each read as a subject: the control)."""
    rd = pb_judge.Readings()
    extra = {p: pb_judge.Readings() for p in (also or ())}
    ref = reference(cfg, params, geom, precision)
    others = {p: reference(cfg, params, geom, p) for p in extra}
    for cid, sub in subjects.items():
        rc, logits, first = replay(ref, records[cid])
        D = ref.density(rc)
        pb_judge.read_context(rd, logits, sub, first, D, rc.enc,
                              ref.min_bits)
        for p, r in others.items():
            oc, olog, ofirst = replay(r, records[cid])
            osub = pb_judge.subject_from_reference(
                olog, ofirst, r.density(oc), oc.enc, ref.min_bits)
            pb_judge.read_context(extra[p], logits, osub, first, D, rc.enc,
                                  ref.min_bits)
            del oc, olog
        del rc, logits
    return rd, extra


def run(args, t_proc0: float, device="cuda", trace_factory=DeviceTrace,
        break_program=None, root=None) -> int:
    """One run; prints the result line last.  -> exit code."""
    root = Path(root) if root else HERE.parent
    try:
        wl, conf, mix, limits, e2e, per_layer = cell_spec(root, args.workload)
    except (Refused, OSError, KeyError, StopIteration, ValueError) as e:
        log(f"portbench: cannot read the cell: {e!r}")
        return 2
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            log(f"portbench: needs {wl['chips']} CUDA device(s); "
                f"available: {torch.cuda.is_available()}, count "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        torch.cuda.reset_peak_memory_stats()
    cell = Cell(conf, mix, args.seed, device)
    if break_program is not None:
        break_program(cell)
    trace = trace_factory() if args.trace else None
    cell.window(args.seconds, trace)
    metrics = end_to_end(cell, cell.t0 - t_proc0)
    n_done = sum(1 for c in cell.calls if c.stream.done
                 and c.stream.error is None)
    n_fail = sum(1 for c in cell.calls if c.stream.done
                 and c.stream.error is not None)
    n_unfinished = sum(1 for c in cell.calls if not c.stream.done)
    reads = [s.info["read"] for s in cell.spans.within(
        "begin_call", cell.t0, cell.t_drained) if s.info["req"] in
        {id(c.stream.request) for c in cell.calls}]
    log(f"calls completed {n_done}, failed {n_fail}, unfinished "
        f"{n_unfinished}, redirected {cell.redirects}, refused "
        f"{cell.refused}")
    log(f"calls that read from disk: {sum(r > 0 for r in reads)} of "
        f"{len(reads)}; read {cell.w_read} B in the window")
    log(f"bytes written to disk: set-up {cell.written_setup}, window "
        f"{cell.w_written}; KV budget {cell.budget} B")
    if device == "cuda":
        import subprocess
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            smi = "nvidia-smi unavailable"
        log(f"card: {smi}")
        peak = max(torch.cuda.max_memory_allocated(),
                   torch.cuda.max_memory_reserved())
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    out = {"metrics": {}}
    if args.trace:
        busy, _ = trace.busy()
        dev["busy_s"], dev["window_s"] = busy, trace.window_s
        log(f"trace: {len(trace.ops)} device operations over "
            f"{trace.window_s:.3f} s, busy {busy:.3f} s")
        r = Run(cell.cfg, conf, cell.geom, cell.calls, cell.spans, trace,
                trace.t0, trace.t1, {"busy_s": busy, "w_read": cell.w_read,
                                     "ttfts": ttfts(cell)})
        for m in per_layer:
            v = _load(HERE / "metrics" / f"{m['name']}.py").read(r)
            if v is not None and math.isfinite(v):
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = breakdown(trace, cell.spans)
        missing = [m["name"] for m in per_layer
                   if m["name"] not in out["metrics"]]
        del r
    else:
        for m in e2e:
            out["metrics"][m["name"]] = {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
        missing = [m["name"] for m in e2e
                   if not math.isfinite(metrics[m["name"]])]
    # the program's outputs, read before its state goes
    picked = sample_contexts(cell, args.seed)
    subjects = {cid: pb_judge.program_subject(
        cell.records[cid], cell.svc.contexts[cid], cell.geom.cs)
        for cid in picked}
    records, params, cfg, geom = cell.records, cell.params, cell.cfg, cell.geom
    cell_refused = cell.refused
    cell.close()
    del cell, trace
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rd, _ = compare(cfg, params, geom, records, subjects)
    numbers = rd.numbers()
    numbers["calls_unfinished"] = float(n_unfinished)
    numbers["calls_failed"] = float(n_fail)
    numbers["calls_refused"] = float(cell_refused)
    log(f"reference: {len(picked)} contexts in "
        f"{time.perf_counter() - t_ref:.1f} s")
    correct = pb_judge.verdict(numbers, limits)
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                  **lim} for k, lim in limits.items()}
    bad = forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 4
    if missing:
        log(f"portbench: metrics listed for this cell are missing: {missing}")
        return 5
    for k, c in checks.items():
        lim = " ".join(f"{b} {c[b]}" for b in ("min", "max") if b in c)
        log(f"check {k} {c['value']!r} limit {lim or 'none'}")
    line = {"correct": bool(correct), "attempted": n_done + n_fail
            + n_unfinished + cell_refused,
            "failed": n_fail + n_unfinished + cell_refused,
            "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
