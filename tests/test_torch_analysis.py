"""The port's concurrency/JIT discipline analyzer
(``repro_torch.analysis``): the reference's analyzer tests run against
it, its findings held to the reference analyzer's on one corpus, the
seven findings of the port's tree each flagged again without its
resolution, the analyzer running with torch, numpy, JAX and the
reference package unimportable, and the runtime lock-order witness on
both packages' threaded routers.

Only the last test imports JAX (through the reference's router); the
analyzer itself is stdlib only.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from repro.analysis import runner as jrunner
from repro_torch.analysis import baseline, config
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import (
    DEFAULT_BASELINE, REPO_ROOT, analyze_source, build_program, run_default)
from repro_torch.analysis.runtime import (
    LockOrderError, OrderedLock, order_graph, reset_witness,
    witness_condition, witness_lock, witness_rlock)

FIXDIR = REPO_ROOT / "src" / "repro_torch" / "analysis" / "fixtures"
REF_FIXDIR = REPO_ROOT / "src" / "repro" / "analysis" / "fixtures"
FIXTURES = ("pr3_deadlock.py", "pr6_restore_race.py", "family_dispatch.py")


def rules(findings):
    return sorted(f"{f.checker}/{f.rule}" for f in findings)


def analyze(src):
    return analyze_source(textwrap.dedent(src))


# the inline corpus of the reference's analyzer tests, shared by the
# tests below and by the parity test against the reference analyzer
CORPUS = {
    "locked_call": """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def _bump_locked(self):
                self.n += 1

            def good(self):
                with self._lock:
                    self._bump_locked()

            def bad(self):
                self._bump_locked()
    """,
    "blocking_under_lock": """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                with self._lock:
                    time.sleep(0.01)

            def good(self):
                time.sleep(0.01)
    """,
    "condition_wait": """
        import threading

        class Q:
            def __init__(self):
                self._cv = threading.Condition()
                self.items = []

            def pop(self):
                with self._cv:
                    while not self.items:
                        self._cv.wait()
                    return self.items.pop()
    """,
    "jit_self_closure": """
        import jax

        class Model:
            def __init__(self):
                self.scale = 2.0
                self.fn = jax.jit(lambda x: x * self.scale)
    """,
    "jit_host_call": """
        import jax

        def make():
            def step(x):
                print(x)
                return x + 1
            return jax.jit(step)
    """,
    "unhashable_key": """
        def lookup(cache, model, shape):
            key = [id(model), shape]
            return cache[key]
    """,
    # the family-string guard the port's service held until every
    # family was built (its source before it was deleted)
    "refuse_unported": """
        def _refuse_unported(model: ModelBase) -> None:
            from repro_torch.models.registry import FAMILY_CLASSES
            if model.cfg.family not in FAMILY_CLASSES:
                raise NotImplementedError(
                    f"family {model.cfg.family!r} is not ported yet")
    """,
}


# the port's counterpart of jax.jit: a CUDA-graph body handed to
# core/graphs.py's capture helper (port-only: the reference has none)
GRAPH_CORPUS = {
    "graph_self_closure": """
        from repro_torch.core.graphs import capturable

        class Executor:
            def body(self):
                def run(inp):
                    return inp["x"] * self.scale
                return capturable(run)
    """,
    "graph_host_sync": """
        from repro_torch.core import graphs

        def make(model, params):
            def run(inp):
                n = int(inp["seq_len"])
                m = inp["x"].sum().item()
                return model.step(params, inp["x"][:n]).cpu() * m
            return graphs.capturable(run)
    """,
    "graph_host_call": """
        import time
        from repro_torch.core.graphs import capturable

        def make(model, params):
            return capturable(lambda inp: model.step(params, inp["x"],
                                                     time.time()))
    """,
    "graph_clean": """
        from repro_torch.core.graphs import capturable

        class Executor:
            def body(self, arenas):
                model, params, cw = self.model, self.params, self.cw

                def run(inp):
                    out = model.step(params, inp["x"], arenas, **cw)
                    last = out.index_select(1, inp["last"])
                    return (last.to(float),)
                return capturable(run)
    """,
    # host syncs outside a graph body, or in a function never handed to
    # the helper, are not the rule's business
    "graph_sync_outside": """
        from repro_torch.core.graphs import capturable

        def make(model):
            def run(inp):
                return (model.step(inp["x"]),)

            def read(out):
                return out.cpu().numpy().tolist(), int(out[0])
            return capturable(run), read
    """,
}


# --------------------------------------------------------------------- #
# static checkers: inline fixture corpus
# --------------------------------------------------------------------- #

def test_locked_call_without_lock_flagged():
    fs = analyze(CORPUS["locked_call"])
    assert rules(fs) == ["lock/locked-call"]
    (f,) = fs
    assert f.scope == "Counter.bad"


def test_blocking_under_lock_flagged():
    fs = analyze(CORPUS["blocking_under_lock"])
    assert rules(fs) == ["lock/blocking-under-lock"]
    assert fs[0].scope == "Poller.bad"


def test_condition_wait_under_own_lock_allowed():
    # Condition.wait releases the lock while blocked (allow_held)
    fs = analyze(CORPUS["condition_wait"])
    assert "lock/blocking-under-lock" not in rules(fs)


def test_jit_self_closure_flagged():
    fs = analyze(CORPUS["jit_self_closure"])
    assert "jit/self-in-traced-fn" in rules(fs)


def test_jit_host_call_flagged():
    fs = analyze(CORPUS["jit_host_call"])
    assert "jit/host-call-in-jit" in rules(fs)


def test_graph_body_self_closure_flagged():
    fs = analyze(GRAPH_CORPUS["graph_self_closure"])
    assert rules(fs) == ["jit/self-in-traced-fn"]
    assert fs[0].scope == "Executor.body" and "graph body" in fs[0].message


def test_graph_body_host_syncs_flagged():
    fs = analyze(GRAPH_CORPUS["graph_host_sync"])
    assert rules(fs) == ["jit/host-call-in-jit"] * 3
    assert sorted(f.message.split(" calls ")[1].split(":")[0]
                  for f in fs) == [".cpu()", ".item()", "int()"]


def test_graph_body_host_call_flagged():
    fs = analyze(GRAPH_CORPUS["graph_host_call"])
    assert rules(fs) == ["jit/host-call-in-jit"]
    assert "time.time()" in fs[0].message


@pytest.mark.parametrize("name", ["graph_clean", "graph_sync_outside"])
def test_graph_body_clean_passes(name):
    assert analyze(GRAPH_CORPUS[name]) == []


def test_executor_graph_bodies_are_checked():
    """The executor's three bodies (extend, decode, the pipelined
    restore) are the rule's targets in the tree, and each passes: a body
    that read ``self`` or synced would be flagged."""
    src = (REPO_ROOT / "src/repro_torch/core/executor.py").read_text()
    tree = ast.parse(src)
    helpers = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "capturable"]
    assert len(helpers) == 3
    assert [f for f in analyze_source(src) if f.checker == "jit"] == []
    bad = src.replace('last = hidden.index_select(1, inp["last"])[:, 0]',
                      'last = hidden[:, int(inp["last"])] * self.cs')
    assert bad != src
    assert rules(f for f in analyze_source(bad) if f.checker == "jit") == [
        "jit/host-call-in-jit", "jit/self-in-traced-fn"]
    bad = src.replace('ops.feed_gate(flags, layer, inp["gen"],',
                      'ops.feed_gate(self.flags, layer, inp["gen"].item(),')
    assert bad != src
    assert rules(f for f in analyze_source(bad) if f.checker == "jit") == [
        "jit/host-call-in-jit", "jit/self-in-traced-fn"]


def test_unhashable_jit_key_flagged():
    # the `id(model)` cache-key bug class
    fs = analyze(CORPUS["unhashable_key"])
    assert "jit/unhashable-jit-key" in rules(fs)


# --------------------------------------------------------------------- #
# committed regression fixtures (also exercised by --selftest)
# --------------------------------------------------------------------- #

def test_pr3_deadlock_fixture_flagged():
    src = (FIXDIR / "pr3_deadlock.py").read_text()
    assert "lock/blocking-in-worker" in rules(analyze_source(src))


def test_family_dispatch_fixture_flagged():
    src = (FIXDIR / "family_dispatch.py").read_text()
    flagged = [f for f in analyze_source(src)
               if f.checker == "family" and f.rule == "string-dispatch"]
    # the two old executor gates + the != fork; the `fam not in` local
    # alias is deliberately out of reach (name-based, no dataflow)
    assert len(flagged) >= 3
    assert {f.scope for f in flagged} == {"OldExecutor.init_cache"}


def test_family_dispatch_registry_allowlisted():
    # the registry IS the dispatch point: scanning the real tree must
    # not flag it (covered by the repo-clean gate below, but assert the
    # allowlist explicitly so a rename breaks loudly)
    assert "src/repro_torch/models/registry.py" in \
        config.FAMILY_DISPATCH_ALLOWED_FILES
    assert (REPO_ROOT / "src/repro_torch/models/registry.py").exists()


def test_pr6_restore_race_fixture_flagged():
    src = (FIXDIR / "pr6_restore_race.py").read_text()
    fs = analyze_source(src)
    flagged = [f for f in fs if f.rule == "unordered-store-read"]
    assert len(flagged) == 1
    # only the unordered variant — restore_chunk_fixed waits first
    assert flagged[0].scope == "BadRestore.restore_chunk"


# --------------------------------------------------------------------- #
# baseline round-trip
# --------------------------------------------------------------------- #

def _finding(msg="blocking call under lock", line=10):
    return Finding(checker="lock", rule="blocking-under-lock",
                   file="src/x.py", line=line, scope="C.f", message=msg)


def test_baseline_round_trip(tmp_path):
    path = tmp_path / "base.json"
    old = _finding()
    baseline.write(path, [old])
    known = baseline.load(path)
    assert old.fingerprint in known

    moved = _finding(line=99)          # pure code motion: same identity
    fresh = _finding(msg="a brand-new finding")
    new, grandfathered = baseline.diff([moved, fresh], known)
    assert [f.message for f in grandfathered] == [moved.message]
    assert [f.message for f in new] == [fresh.message]


def test_baseline_missing_file_is_empty(tmp_path):
    assert baseline.load(tmp_path / "nope.json") == set()


# --------------------------------------------------------------------- #
# runtime lock-order witness
# --------------------------------------------------------------------- #

@pytest.fixture(autouse=True)
def _clean_graph():
    reset_witness()
    yield
    reset_witness()


def test_ordered_lock_records_edges():
    a, b = OrderedLock("A"), OrderedLock("B")
    with a:
        with b:
            pass
    assert "B" in order_graph().get("A", set())


def test_ordered_lock_cycle_raises():
    a, b = OrderedLock("A"), OrderedLock("B")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(LockOrderError):
            a.acquire()
        # the refused acquire must not leave state behind
    assert "A" not in order_graph().get("B", set())


def test_ordered_lock_reentry_no_self_edge():
    r = OrderedLock("R", threading.RLock())
    with r:
        with r:
            pass
    assert "R" not in order_graph().get("R", set())


def test_two_thread_inversion_detected():
    """End-to-end: opposite-order acquisition across two threads raises
    instead of deadlocking."""
    a, b = OrderedLock("A"), OrderedLock("B")
    ready = threading.Event()
    errors = []

    def t1():
        with a:
            with b:
                ready.set()

    def t2():
        ready.wait(5)
        try:
            with b:
                with a:
                    pass
        except LockOrderError as e:
            errors.append(e)

    th1, th2 = threading.Thread(target=t1), threading.Thread(target=t2)
    th1.start()
    th1.join(5)
    th2.start()
    th2.join(5)
    assert len(errors) == 1
    assert "inversion" in str(errors[0])


def test_witness_env_gating(monkeypatch):
    monkeypatch.delenv("LLMS_LOCK_WITNESS", raising=False)
    assert not isinstance(witness_lock("x"), OrderedLock)
    monkeypatch.setenv("LLMS_LOCK_WITNESS", "1")
    assert isinstance(witness_lock("x"), OrderedLock)
    assert isinstance(witness_rlock("x"), OrderedLock)
    cv = witness_condition("x")
    assert isinstance(cv, threading.Condition)
    with cv:
        cv.notify_all()


# --------------------------------------------------------------------- #
# the clean-tree gate
# --------------------------------------------------------------------- #

def test_repo_is_clean_against_baseline():
    new, old = run_default()
    assert new == [], "\n".join(f.render() for f in new)
    # nothing is grandfathered: the port's baseline is empty
    assert old == []
    assert json.loads(DEFAULT_BASELINE.read_text()) == {
        "version": 1, "findings": []}


# --------------------------------------------------------------------- #
# parity with the reference analyzer
# --------------------------------------------------------------------- #

def _key(findings):
    return sorted((f.checker, f.rule, f.line, f.scope) for f in findings)


@pytest.mark.parametrize("name", sorted(CORPUS) + list(FIXTURES))
def test_findings_match_the_reference_analyzer(name):
    """Both analyzers give the same (checker, rule, line, scope) on each
    source of the corpus; a fixture is read from both packages, whose
    copies keep their lines aligned."""
    if name in CORPUS:
        sources = [textwrap.dedent(CORPUS[name])]
    else:
        sources = [(d / name).read_text() for d in (FIXDIR, REF_FIXDIR)]
    keys = set()
    for src in sources:
        mine = _key(analyze_source(src))
        assert mine == _key(jrunner.analyze_source(src))
        keys.add(tuple(mine))
    assert len(keys) == 1


# --------------------------------------------------------------------- #
# the blocking rule translated for the port: ModelExecutor's entries
# --------------------------------------------------------------------- #

_EXE_UNDER_LOCK = """
    import threading

    class Pump:
        def __init__(self, exe):
            self._lock = threading.Lock()
            self.exe = exe

        def bad_decode(self, arenas, toks, pos):
            with self._lock:
                return self.exe.paged_decode(arenas, toks, pos)

        def bad_sync(self):
            with self._lock:
                self.exe.sync()

        def good(self, arenas, toks, pos):
            with self._lock:
                n = len(toks)
            self.exe.sync()
            return self.exe.paged_decode(arenas, toks, pos), n

    class ServiceRouter:
        def __init__(self, exe):
            self._svc_lock = threading.RLock()
            self.exe = exe

        def coarse(self, arenas, toks, pos):
            with self._svc_lock:
                return self.exe.paged_decode(arenas, toks, pos)
"""


def test_executor_entries_under_a_narrow_lock_flagged():
    """``self.exe.paged_decode(...)`` and ``self.exe.sync()`` under a
    narrow lock are the port's "jitted-entry execution under a lock";
    outside it, and under the coarse ``_svc_lock``, they pass."""
    fs = [f for f in analyze(_EXE_UNDER_LOCK)
          if f.rule == "blocking-under-lock"]
    assert sorted((f.scope, f.message.split("(")[0]) for f in fs) == [
        ("Pump.bad_decode", "paged_decode"), ("Pump.bad_sync", "sync")]
    # the reference's `*_fn` rule does not see the port's entries
    ref = jrunner.analyze_source(textwrap.dedent(_EXE_UNDER_LOCK))
    assert "lock/blocking-under-lock" not in rules(ref)


@pytest.mark.parametrize("entry", ["recompute", "extend_nod", "extend",
                                   "decode", "run_pipelined",
                                   "paged_extend", "paged_decode", "sync",
                                   "logits"])
def test_each_executor_entry_is_a_blocking_call(entry):
    src = f"""
        import threading

        class Pump:
            def __init__(self, exe):
                self._lock = threading.Lock()
                self.exe = exe

            def bad(self):
                with self._lock:
                    self.exe.{entry}()

            def other_receiver(self, model):
                with self._lock:
                    model.{entry}()
    """
    fs = analyze(src)
    assert [(f.rule, f.scope) for f in fs] == [
        ("blocking-under-lock", "Pump.bad")]


# --------------------------------------------------------------------- #
# the seven findings of the port's tree, each without its resolution
# --------------------------------------------------------------------- #

def test_zero_cache_flagged_without_its_allowlist_entry(monkeypatch):
    allow = dict(config.SHARED_STATE_ALLOWLIST)
    del allow[("ModelExecutor", "_zero_cache")]
    monkeypatch.setattr(config, "SHARED_STATE_ALLOWLIST", allow)
    new, _ = run_default()
    assert [(f.checker, f.rule, f.file, f.scope) for f in new] == [
        ("shared", "unguarded-shared-write",
         "src/repro_torch/core/executor.py", "ModelExecutor._zero")]


def _call_sites(attr):
    """-> the functions of the port's tree that call ``<x>.attr(...)``
    in their own body (not in a nested def)."""
    found = []
    for mod in build_program().modules:
        for fn in mod.all_functions:
            todo = list(fn.node.body)
            while todo:
                node = todo.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    continue
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == attr:
                    found.append(fn)
                    break
                todo.extend(ast.iter_child_nodes(node))
    return found


def test_zero_cache_is_reached_on_the_serialized_surface_only():
    """The allowlist entry's proof: ``_zero`` is called only by
    ``ModelExecutor.__init__`` and ``fresh_cache``, and every caller of
    ``fresh_cache`` is ``@requires_serialized`` (which the lock checker
    holds to ``_svc_lock`` or an inline driver)."""
    assert sorted(f.qualname for f in _call_sites("_zero")) == [
        "ModelExecutor.__init__", "ModelExecutor.fresh_cache"]
    fresh = _call_sites("fresh_cache")
    assert {f.qualname for f in fresh} == {
        "LLMService._condense", "ResidencyEngine.switch_in",
        "ResidencyEngine.profile_pipeline"}
    assert all(f.serialized for f in fresh)


def test_convert_flagged_without_its_allowlist_entry(monkeypatch):
    conv = "src/repro_torch/models/convert.py"
    monkeypatch.setattr(config, "FAMILY_DISPATCH_ALLOWED_FILES",
                        config.FAMILY_DISPATCH_ALLOWED_FILES - {conv})
    new, _ = run_default()
    lines = [i for i, ln in enumerate(
        (REPO_ROOT / conv).read_text().splitlines(), 1)
        if "cfg.family" in ln]
    assert len(lines) == 5
    assert [(f.rule, f.file, f.scope, f.line) for f in new] == [
        ("string-dispatch", conv, "params_from_jax", ln) for ln in lines]


def test_refuse_unported_flagged_as_inline_fixture():
    fs = analyze(CORPUS["refuse_unported"])
    assert [(f.rule, f.scope) for f in fs] == [
        ("string-dispatch", "_refuse_unported")]
    svc = (REPO_ROOT / "src/repro_torch/core/service.py").read_text()
    assert "_refuse_unported" not in svc


# --------------------------------------------------------------------- #
# stdlib only: the analyzer with torch, numpy, JAX and repro refused
# --------------------------------------------------------------------- #

_REFUSING = """
import sys
BANNED = ("torch", "numpy", "jax", "jaxlib", "repro")
assert not [m for m in sys.modules if m.split(".")[0] in BANNED]


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ModuleNotFoundError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
from repro_torch.analysis.__main__ import main
rc = main(sys.argv[1:])
assert not [m for m in sys.modules if m.split(".")[0] in BANNED]
sys.exit(rc)
"""


@pytest.mark.parametrize("args,said", [
    ([], "analysis clean: 0 new findings\n"),
    (["--selftest"], "selftest passed"),
], ids=["tree", "selftest"])
def test_analyzer_runs_without_torch_numpy_jax_or_repro(args, said):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _REFUSING, *args],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert said in out.stdout


# --------------------------------------------------------------------- #
# the witness on both packages' threaded routers
# --------------------------------------------------------------------- #

def test_witness_graphs_of_both_routers_agree(monkeypatch):
    """Both packages' routers, threaded (``start=True``, two submitting
    apps), on one trace of the reduced smollm-360m (6 contexts, 16
    calls, ``decode_batch=4``, a budget of 3 raw chunks) with the
    lock-order witness on: no call fails, no ``LockOrderError``, and the
    two lock-order graphs are equal."""
    torch = pytest.importorskip("torch")
    from _torch_parity import services
    from repro.analysis import runtime as jruntime
    from repro.core.scheduler import ServiceRouter as JRouter
    from repro.launch import serve as jserve
    from repro.trace.synth import synthesize as jsynthesize
    from repro_torch.analysis import runtime as truntime
    from repro_torch.core.scheduler import ServiceRouter as TRouter
    from repro_torch.launch import serve as tserve
    from repro_torch.trace.synth import synthesize as tsynthesize

    monkeypatch.setenv("LLMS_LOCK_WITNESS", "1")
    raw_chunk = 2 * 4 * 16 * 2 * 16 * 2     # k+v, L * cs * KV * hd, bf16
    js, ts, tcfg = services(decode_batch=4, budget=3 * raw_chunk)
    graphs = []
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)                # as _torch_parity's fixture
    try:
        for svc, router_cls, serve, synth, runtime in (
                (js, JRouter, jserve, jsynthesize, jruntime),
                (ts, TRouter, tserve, tsynthesize, truntime)):
            events = synth(6, 16, tcfg.vocab, pattern="markov",
                           scale=0.05, seed=2)
            runtime.reset_witness()
            with svc, router_cls(svc, predict=True, start=True,
                                 slice_steps=4) as router:
                stats = serve.run_trace(router, events, n_apps=2,
                                        priority_mix="1:1", max_new=6)
            assert stats["failed_calls"] == 0
            assert stats["router"]["decode_rounds"] > 0
            graphs.append(runtime.order_graph())
            runtime.reset_witness()
    finally:
        torch.set_num_threads(n_threads)
    assert graphs[1] == graphs[0] == {"scheduler.svc": {
        "requests.stream", "residency.flags", "scheduler.cv",
        "swap.pending"}}
