"""The fault ladder on the port's paged engine, held against the JAX
package: the paged end-to-end cases of tests/test_faults.py.

Each case runs the same seeded fault plan and the same calls through
both packages' services (the reduced smollm-360m, head scaled as in
tests/test_torch_service.py, each package's own failpoint registry), and
compares what the reference's test asserts plus the port against the
reference: tokens, and the recovery counters (corrupt chunks detected,
chunks recomputed, retries, degraded-mode entries and exits, failed
recoveries).  Counters are read after ``swapper.flush()`` so that the
asynchronous AoT writes have landed (ROADMAP.md, Queue 3).  Tolerance:
none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, services  # noqa: F401
from repro.core import faults as jfaults
from repro.core.scheduler import ServiceRouter as JRouter
from repro_torch.core import faults as tfaults
from repro_torch.core.requests import BACKGROUND, FOREGROUND
from repro_torch.core.scheduler import ServiceRouter as TRouter

PKGS = {"jax": (jfaults, JRouter), "torch": (tfaults, TRouter)}
_COUNTERS = ("faults_injected_total", "chunks_corrupt_detected",
             "chunks_recovered_recompute", "recover_failed", "io_retries",
             "io_failed_jobs", "degraded_entries", "degraded_exits",
             "degraded_mode", "evict_dropped")


@pytest.fixture(autouse=True)
def _clean_faults():
    for f, _ in PKGS.values():
        f.clear_faults()
    yield
    for f, _ in PKGS.values():
        f.clear_faults()
        f.set_disk_full(False)


def _svc(pkg, policy="llms_nocomp", budget=12_000):
    js, ts, cfg = services(policy=policy, budget=budget, chunk_tokens=16,
                           port_only=pkg == "torch")
    if js is not None:
        ts.close()
    return (ts if pkg == "torch" else js), cfg


def _drive(svc, cfg, n_ctx=3, rounds=9, seed=7, max_new=4, disk_full=None,
           faults=None):
    rng = np.random.RandomState(seed)
    stubs = [svc.newLLMCtx() for _ in range(n_ctx)]
    outs, degraded = [], []
    for r in range(rounds):
        if disk_full is not None and r in disk_full:
            faults.set_disk_full(disk_full[r])
        prompt = rng.randint(1, cfg.vocab, size=12).tolist()
        outs.append(svc.callLLM(stubs[r % n_ctx], prompt,
                                max_new_tokens=max_new)[1])
        degraded.append(bool(svc.res.degraded))
    return outs, degraded


def _counters(svc):
    svc.swapper.flush(raise_errors=False)
    st = svc.stats()
    return {k: st[k] for k in _COUNTERS}


def _both(run):
    out = {pkg: run(pkg) for pkg in PKGS}
    assert out["torch"] == out["jax"], out
    return out["torch"]


def test_corrupt_chunk_recovery_token_identity():
    """Bit-flipped chunk files are detected by CRC and recovered by
    recompute; under the 16-bit policy the recovered run's tokens equal
    the fault-free run's, in both packages."""
    def run(pkg):
        faults = PKGS[pkg][0]
        svc, cfg = _svc(pkg)
        with svc:
            clean, _ = _drive(svc, cfg)
        faults.install_faults(
            [faults.FaultSpec(kind="bit_flip", sites=("disk.write",),
                              rate=0.25)], seed=2024)
        svc2, _ = _svc(pkg)
        try:
            faulty, _ = _drive(svc2, cfg)
            st = _counters(svc2)
        finally:
            faults.clear_faults()
            svc2.close()
        return clean, faulty, st

    clean, faulty, st = _both(run)
    assert st["faults_injected_total"] > 0, "no faults drawn: dead test"
    assert st["chunks_corrupt_detected"] > 0
    assert st["chunks_recovered_recompute"] > 0
    assert st["recover_failed"] == 0
    assert faulty == clean


def test_transient_eio_recovered_by_retries():
    def run(pkg):
        faults = PKGS[pkg][0]
        faults.install_faults(
            [faults.FaultSpec(kind="transient_eio",
                              sites=("disk.read", "disk.write",
                                     "swap.worker"),
                              rate=0.10, fail_n=1)], seed=77)
        svc, cfg = _svc(pkg)
        try:
            outs, _ = _drive(svc, cfg)
            st = _counters(svc)
        finally:
            faults.clear_faults()
            svc.close()
        return outs, st

    _, st = _both(run)
    assert st["faults_injected_total"] > 0
    assert st["io_retries"] > 0
    assert st["io_failed_jobs"] == 0
    assert st["recover_failed"] == 0


def test_enospc_degraded_cycle_token_identity():
    """A disk-full window over calls 4-7: degraded mode is entered,
    calls keep completing, the probe exits the mode, and the tokens
    equal the fault-free run's, in both packages."""
    def run(pkg):
        faults = PKGS[pkg][0]
        svc, cfg = _svc(pkg)
        with svc:
            clean, _ = _drive(svc, cfg, rounds=12)
        svc3, _ = _svc(pkg)
        try:
            outs, degraded = _drive(svc3, cfg, rounds=12, faults=faults,
                                    disk_full={4: True, 8: False})
            st = _counters(svc3)
        finally:
            faults.clear_faults()
            svc3.close()
        return clean, outs, degraded, st

    clean, outs, degraded, st = _both(run)
    assert degraded[6], "writes failing but degraded mode never entered"
    assert st["degraded_entries"] >= 1
    assert st["degraded_exits"] >= 1
    assert not st["degraded_mode"], "probe never exited degraded mode"
    assert outs == clean
    assert st["recover_failed"] == 0


def test_degraded_sheds_background_until_fg_served():
    def run(pkg):
        faults, router_cls = PKGS[pkg]
        svc, cfg = _svc(pkg, budget=200_000)
        router = router_cls(svc, predict=False, start=False, slice_steps=2)
        try:
            fg = router.register_app("fg", "foreground")
            bg = router.register_app("bg", "background")
            sf, sb = fg.new_ctx(), bg.new_ctx()
            st_bg = bg.stream(sb, [1, 2, 3], max_new_tokens=2)
            st_fg = fg.stream(sf, [4, 5, 6], max_new_tokens=2)
            svc.res._enter_degraded()
            jobs = router._pop_batch(4, set())
            first = [j["prio"] for j in jobs]
            shed = router.bg_shed
            router._run_batch(jobs, refill=False)
            jobs2 = router._pop_batch(4, set())
            second = [j["prio"] for j in jobs2]
            router._run_batch(jobs2, refill=False)
            assert st_fg.done and st_bg.done
            assert st_fg.error is None and st_bg.error is None
            return (first, shed, second, router.stats()["bg_shed"],
                    st_fg.result(), st_bg.result())
        finally:
            router.shutdown()
            faults.clear_faults()
            svc.close()

    first, shed, second, bg_shed, _, _ = _both(run)
    assert first == [FOREGROUND] and shed == 1
    assert second == [BACKGROUND]          # livelock guard: not shed
    assert bg_shed == 1


def test_watchdog_timeout_requeues_then_fails():
    def run(pkg):
        faults, router_cls = PKGS[pkg]
        svc, cfg = _svc(pkg, budget=200_000)
        router = router_cls(svc, predict=False, start=False)
        try:
            app = router.register_app("a", "foreground")
            stub = app.new_ctx()
            real = svc.begin_call
            calls = {"n": 0}

            def wedged_twice(stub_, req):
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise faults.SwapTimeoutError("swap wedged")
                return real(stub_, req)

            svc.begin_call = wedged_twice
            s1 = app.stream(stub, [1, 2, 3], max_new_tokens=2)
            router.drain()
            assert s1.done and s1.error is None
            first = router.watchdog_preempts

            def wedged(*_):
                raise faults.SwapTimeoutError("permanently wedged")

            svc.begin_call = wedged
            s2 = app.stream(stub, [1, 2, 3], max_new_tokens=2)
            router.drain()
            assert isinstance(s2.error, faults.SwapTimeoutError)
            svc.begin_call = real
            return first, router.watchdog_preempts, s1.result()
        finally:
            router.shutdown()
            svc.close()

    first, total, _ = _both(run)
    assert first == 2                       # requeued twice, then served
    assert total == 5                       # 2 + 3 more, then it fails
