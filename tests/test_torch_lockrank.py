"""The port's lock-order detector (minio_tpu_torch.obs.lockrank) held to
the JAX package's (minio_tpu.obs.lockrank): the scenarios of
tests/test_lockrank.py — a seeded ABBA pair, a three-lock cycle, RLock
re-entry, an out-of-order release, a lock held across a flush boundary
(``note_blocking``), the bounded report ring — run on both detectors with
the same named ``tracked()`` locks and must give the same report kinds,
locks, cycles and edges. The threads run one after another: the detectors
flag the order pattern, never an unlucky interleaving.

The port's factory wraps only locks the port (or its tests) creates, over
the raw ``_thread`` primitives, and its install/uninstall leave
``threading.Lock`` as it found it: the test suite's conftest installs the
JAX detector first, and the port's must not wrap or lose it."""
import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.obs import lockrank as jlr  # noqa: E402
from minio_tpu_torch.obs import lockrank as plr  # noqa: E402

LR = {"jax": jlr, "port": plr}


@pytest.fixture
def both(monkeypatch):
    """Both detectors on, with clean graphs; the port's is uninstalled
    after (the JAX one stays as conftest left it)."""
    monkeypatch.setenv("MINIO_TPU_LOCKRANK", "1")
    jax_was_on = jlr.enabled()
    assert plr.install()
    if not jax_was_on:
        assert jlr.install()
    for lr in LR.values():
        lr.clear()
    yield LR
    plr.uninstall()
    if not jax_was_on:
        jlr.uninstall()
    for lr in LR.values():
        lr.clear()


def _in_thread(fn, *args):
    t = threading.Thread(target=fn, args=args, name=fn.__name__)
    t.start()
    t.join(10)
    assert not t.is_alive()


def _take_in_order(first, second):
    with first:
        with second:
            pass


def _abba(lr, tag):
    a, b = lr.tracked(f"{tag}-A"), lr.tracked(f"{tag}-B")
    _in_thread(_take_in_order, a, b)
    _in_thread(_take_in_order, b, a)


def _consistent(lr, tag):
    a, b = lr.tracked(f"{tag}-A"), lr.tracked(f"{tag}-B")
    _in_thread(_take_in_order, a, b)
    _in_thread(_take_in_order, a, b)


def _three_cycle(lr, tag):
    a, b, c = (lr.tracked(f"{tag}-{x}") for x in "ABC")
    _in_thread(_take_in_order, a, b)
    _in_thread(_take_in_order, b, c)
    _in_thread(_take_in_order, c, a)


def _reentry(lr, tag):
    r = lr.tracked(f"{tag}-R", reentrant=True)
    with r:
        with r:
            pass


def _out_of_order(lr, tag):
    a, b, c = (lr.tracked(f"{tag}-{x}") for x in "ABC")

    def weird():
        a.acquire()
        b.acquire()
        a.release()                 # A out from under B
        with c:                     # the edge is B -> C, not A -> C
            pass
        b.release()

    _in_thread(weird)
    _in_thread(_take_in_order, a, b)


def _blocking(lr, tag):
    lk = lr.tracked(f"{tag}-holder")
    lr.note_blocking("device_flush:encode")   # nothing held: silent
    with lk:
        lr.note_blocking("device_flush:encode")


def _ring(lr, tag):
    lk = lr.tracked(f"{tag}-ring")
    with lk:
        for _ in range(lr._MAX_REPORTS + 5):
            lr.note_blocking("device_flush:ring")


SCENARIOS = {"abba": _abba, "consistent": _consistent,
             "three_cycle": _three_cycle, "reentry": _reentry,
             "out_of_order": _out_of_order, "note_blocking": _blocking,
             "report_ring": _ring}


def _summary(lr) -> dict:
    """Reports without their stacks and thread names (each package's
    frames differ), and the graph's counters."""
    reps = []
    for r in lr.reports():
        row = {"kind": r["kind"], "locks": r["locks"]}
        if r["kind"] == "lock-order-cycle":
            row["cycle"] = r["cycle"]
            row["edges"] = sorted(e["edge"] for e in r["edges"])
            assert all("_take_in_order" in e["stack"] for e in r["edges"])
        else:
            row["what"] = r["what"]
            row["lock_sites"] = r["lock_sites"]
        reps.append(row)
    st = lr.stats()
    return {"reports": reps, "edges": st["edges"], "sites": st["sites"],
            "suppressed": lr.suppressed_report_count()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_reports_match_jax(both, name):
    got = {}
    for pkg, lr in both.items():
        SCENARIOS[name](lr, name)
        got[pkg] = _summary(lr)
    assert got["port"] == got["jax"]
    kinds = [r["kind"] for r in got["port"]["reports"]]
    want = {"abba": ["lock-order-cycle"], "consistent": [],
            "three_cycle": ["lock-order-cycle"], "reentry": [],
            "out_of_order": [],
            "note_blocking": ["lock-held-across-blocking"],
            "report_ring": ["lock-held-across-blocking"] *
            plr._MAX_REPORTS}[name]
    assert kinds == want
    if name == "three_cycle":
        assert len(got["port"]["reports"][0]["edges"]) == 3
    if name == "report_ring":
        assert got["port"]["suppressed"] == 5


def test_factory_wraps_port_locks_only(both):
    """Locks this module (the port's tests) and port modules create come
    back as the port's tracked locks over raw primitives; a stdlib
    module's and the JAX package's get raw locks, never a JAX-wrapped
    one."""
    import queue

    from minio_tpu.obs import latency as jlat
    from minio_tpu_torch.obs import latency as plat
    lk, rlk = threading.Lock(), threading.RLock()
    assert isinstance(lk, plr.TrackedLock) and isinstance(rlk, plr.TrackedLock)
    assert type(lk._inner) is type(plr._RAW_LOCK())
    with lk:
        assert plr.held_names() == [lk.name]
        assert jlr.held_names() == []
    assert plr.held_names() == []
    assert lk.site.startswith("test_torch_lockrank.py:")
    assert isinstance(plat.Window(60)._lock, plr.TrackedLock)
    for raw in (queue.Queue().mutex, jlat.Window(60)._lock):
        assert not isinstance(raw, (plr.TrackedLock, jlr.TrackedLock))


def test_install_and_uninstall_leave_threading_lock_as_found(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_LOCKRANK", "1")
    before = (threading.Lock, threading.RLock)
    try:
        assert plr.install() and plr.install()   # idempotent
        assert threading.Lock is plr._lock_factory
        assert threading.RLock is plr._rlock_factory
        assert plr.enabled()
    finally:
        plr.uninstall()
    assert (threading.Lock, threading.RLock) == before
    assert not plr.enabled()
    plr.uninstall()
    assert (threading.Lock, threading.RLock) == before
    monkeypatch.setenv("MINIO_TPU_LOCKRANK", "0")
    assert not plr.install()
    assert threading.Lock is before[0]


def test_contended_acquire_feeds_the_port_profiler(both):
    """A blocked tracked acquire counts its site as contended and lands in
    the port profiler's lock-wait stats, not the JAX profiler's."""
    from minio_tpu.obs import profiler as jprof
    from minio_tpu_torch.obs import profiler as pprof
    lk = plr.tracked("torch-lockrank-contended")
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(10)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    t0 = time.monotonic()
    with lk:
        waited = time.monotonic() - t0
    t.join(10)
    assert plr.contended_sites() == {"torch-lockrank-contended": 1}
    row = pprof.lock_wait_snapshot()["torch-lockrank-contended"]
    assert row["count"] == 1 and 0.1 < row["sum"] <= waited + 0.05
    assert "torch-lockrank-contended" not in jprof.lock_wait_snapshot()
