"""The port's continuous profiler (minio_tpu_torch.obs.profiler) and its
admin surfaces held to the JAX package's (minio_tpu.obs.profiler): the
same synthetic samples fed to both aggregates render identical folded
stacks, speedscope documents and top reports; frames of the port's files
classify to the subsystems the JAX package gives the counterpart files;
each of the port's threads gets the role the JAX table gives its
counterpart; the same lock waits fill identical histograms; a faked SLO
breach starts exactly one burst capture; the ``profile`` and
``profiling/*`` admin ops serve the JAX server's formats."""
import os
import pathlib
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.obs import profiler as jprof  # noqa: E402
from minio_tpu_torch.obs import profiler as pprof  # noqa: E402
from test_torch_s3server import Server  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 20261018
PROF = {"jax": jprof, "port": pprof}


def _samples(n: int) -> list[tuple]:
    """(sig, leaf, role, subsys, tag, waiting) rows from a seed, the
    shape _Sampler._pass feeds."""
    gen = np.random.default_rng(SEED)
    roles = ("dispatcher", "completer", "http-worker", "scanner", "other")
    subs = ("erasure", "runtime", "storage", "obs", "host")
    tags = (None, ("interactive", "s3.put"), ("background", "reconstruct"),
            ("interactive", "encode_hashed"))
    frames = [f"mod{i}.py:fn{i}" for i in range(24)]
    out = []
    for _ in range(n):
        depth = int(gen.integers(1, 7))
        stack = ";".join(frames[int(i)] for i in
                         gen.integers(0, len(frames), depth))
        role = roles[int(gen.integers(0, len(roles)))]
        sub = subs[int(gen.integers(0, len(subs)))]
        tag = tags[int(gen.integers(0, len(tags)))]
        waiting = bool(gen.integers(0, 5) == 0)
        sig = (f"role:{role};class:{tag[0] if tag else '-'};"
               f"subsys:{sub};{stack}" + (";[lockwait]" if waiting else ""))
        out.append((sig, stack.rsplit(";", 1)[-1], role, sub, tag, waiting))
    return out


def test_reports_of_the_same_samples_match_jax():
    rows = _samples(3000)
    got = {}
    for pkg, prof in PROF.items():
        agg = prof._Agg(cap=160, hz=19.0)
        agg.started_mono = float("-inf")  # duration inf on both sides
        agg.passes = 517
        for r in rows:
            agg.feed(*r)
        rep = prof.report_top(agg, n=12)
        rep.pop("lock_contention")   # the process's live lock stats
        got[pkg] = (prof.render_folded(agg), prof.render_speedscope(agg),
                    rep, agg.drops, agg.lockwait)
    assert got["port"] == got["jax"]
    assert got["port"][3] > 0   # the cap dropped stacks on both


def _counterparts() -> list[tuple[str, str]]:
    """(port file, JAX file) pairs with the same path under each package,
    plus the port's files whose JAX counterpart has another name."""
    pairs = []
    for p in sorted((REPO / "minio_tpu_torch").rglob("*.py")):
        rel = p.relative_to(REPO / "minio_tpu_torch")
        j = REPO / "minio_tpu" / rel
        if j.exists():
            pairs.append((str(p), str(j)))
    pairs += [(str(REPO / "minio_tpu_torch/ops/rs_cuda.py"),
               str(REPO / "minio_tpu/ops/rs_pallas.py")),
              (str(REPO / "minio_tpu_torch/ops/hh_torch.py"),
               str(REPO / "minio_tpu/ops/hh_jax.py"))]
    return pairs


def test_port_frames_classify_like_their_jax_counterparts():
    pairs = _counterparts()
    assert len(pairs) > 60
    for p, j in pairs:
        want = jprof._classify_frame_file(j)
        assert want is not None
        assert pprof._classify_frame_file(p) == want, (p, j)
        # the JAX table knows nothing of the port: its frames are host
        assert jprof._classify_frame_file(p) is None
    assert pprof._classify_frame_file(j) is None
    # a live frame of the port: the spin's leaf, subsystem obs
    stop = threading.Event()
    t = threading.Thread(target=pprof.calibrate_spin, args=(10.0, stop))
    t.start()
    try:
        deadline = time.monotonic() + 10
        while True:  # until the thread is inside the spin
            sig, leaf, sub = pprof._fold(sys._current_frames()[t.ident])
            if leaf.endswith(":calibrate_spin") or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.01)
    finally:
        stop.set()
        t.join(10)
    assert leaf == "profiler.py:calibrate_spin" and sub == "obs"
    assert sig.endswith("threading.py:run;profiler.py:calibrate_spin")


#: port thread name -> the JAX package's counterpart
THREADS = {
    "minio-tpu-torch-dispatch-bulk": "minio-tpu-dispatch",
    "minio-tpu-torch-dispatch-interactive": "minio-tpu-dispatch-ia",
    "minio-tpu-torch-complete_3": "minio-tpu-complete_3",
    "minio-tpu-torch-ia-complete": "minio-tpu-ia-complete",
    "minio-torch-fsync-flusher": "minio-tpu-fsync-flusher",
    "minio-torch-io_0": "minio-tpu-io_0",
    "minio-torch-meta_1": "minio-tpu-meta_1",
    "minio-torch-metacache_0": "minio-tpu-metacache_0",
    "data-scanner": "data-scanner",
    "auto-heal": "auto-heal",
    "global-heal_2": "global-heal_2",
    "mrf-healer": "mrf-healer",
    "heal-seq-0123abcd": "heal-seq-0123abcd",
    "tracker-save": "tracker-save",
    "disk-health-/d/d00": "disk-health-/d/d00",
    "minio-tpu-http": "minio-tpu-http",
    "Thread-7 (process_request_thread)":
        "Thread-7 (process_request_thread)",
    "ThreadPoolExecutor-3_1": "ThreadPoolExecutor-3_1",
}


def test_thread_roles_match_jax():
    for port_name, jax_name in THREADS.items():
        assert pprof.thread_role(port_name) == \
            jprof.thread_role(0, jax_name), port_name
    assert pprof.thread_role("minio-tpu-torch-dispatch-bulk") == \
        "dispatcher"
    # the names the port's code really gives its threads
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    from minio_tpu_torch.storage import durability
    q = DispatchQueue("cpu")
    try:
        names = [lane.thread.name for lane in q._lanes()]
        names.append(q._ia_completer.name)
        names.append(q._completers._thread_name_prefix + "_0")
    finally:
        q.stop()
    durability.flusher()._ensure_thread()
    names.append(durability.flusher()._thread.name)
    assert [pprof.thread_role(n) for n in names] == [
        "dispatcher", "dispatcher", "other", "completer", "flusher"]
    assert set(names) <= set(THREADS) | {"minio-tpu-torch-complete_0"}


def test_lock_wait_histograms_match_jax():
    gen = np.random.default_rng(SEED + 1)
    waits = [(f"torch-prof-site-{int(i)}", float(s)) for i, s in
             zip(gen.integers(0, 5, 200), gen.exponential(0.02, 200))]
    waits += [("torch-prof-site-0", b) for b in jprof.LOCK_WAIT_BUCKETS]
    sites = {w[0] for w in waits}
    assert pprof.LOCK_WAIT_BUCKETS == jprof.LOCK_WAIT_BUCKETS
    got = {}
    for pkg, prof in PROF.items():
        for site, s in waits:
            prof.lock_wait_end(site, s)
        snap = {k: v for k, v in prof.lock_wait_snapshot().items()
                if k in sites}
        rows = [r for r in prof.lock_report(10_000) if r["site"] in sites]
        got[pkg] = (snap, rows)
    assert got["port"] == got["jax"]
    for row in got["port"][0].values():
        assert sum(row["buckets"]) == row["count"]
    from minio_tpu_torch.obs.metrics import _g_profiler
    text = "\n".join(_g_profiler(None))
    assert "# TYPE minio_tpu_lock_wait_seconds histogram" in text
    assert 'minio_tpu_lock_wait_seconds_bucket{site="torch-prof-site-0",' \
           'le="0.0005"}' in text


def test_faked_breach_starts_one_burst_capture(monkeypatch):
    from minio_tpu_torch.obs import metrics as mx
    from minio_tpu_torch.obs import slo
    monkeypatch.setenv("MINIO_TPU_PROFILER_BURST_S", "0.3")
    monkeypatch.delenv("MINIO_TPU_PROFILER", raising=False)
    key = 'minio_tpu_profiler_breach_captures_total{class="interactive"}'
    pprof.ensure_started()
    pprof.reset()
    slo.reset()
    try:
        before = mx.counters_snapshot().get(key, 0)
        for _ in range(30):  # errors burn availability in both windows
            slo.record("interactive", 0.01, status=500)
        for _ in range(3):
            rep = slo.report()
            assert rep["classes"]["interactive"]["breach"]["availability"]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and (
                pprof.breach_profile("interactive") is None or
                mx.counters_snapshot().get(key, 0) == before):
            time.sleep(0.05)  # the worker stores, then counts
        stored = pprof.breach_profile("interactive")
        assert stored is not None and stored["class"] == "interactive"
        assert mx.counters_snapshot().get(key, 0) == before + 1
        link = slo.report()["classes"]["interactive"]["breach_profile"]
        assert link["captured"] and link["samples"] == stored["samples"]
        assert not pprof.note_breach("interactive")   # cooling down
    finally:
        slo.reset()
        pprof.reset()


def _admin(c, op, **query):
    return c.request("GET", f"/minio/admin/v3/{op}", query=query or None)


def test_profile_admin_formats_match_jax(tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        prof = PROF[pkg]
        prof.ensure_started()
        s = Server(pkg, tmp_path / pkg)
        try:
            c = s.cl
            out = {}
            top = _admin(c, "profile")
            out["top"] = (top.status_code, sorted(top.json()))
            fresh = _admin(c, "profile", seconds="0.2", hz="50").json()
            out["fresh"] = (sorted(fresh), fresh["duration_s"] < 5.0)
            folded = _admin(c, "profile", fmt="folded")
            out["folded"] = (folded.status_code,
                             folded.content.startswith(b"# samples:"))
            scope = _admin(c, "profile", fmt="speedscope").json()
            out["speedscope"] = (scope["$schema"], scope["exporter"],
                                 sorted(scope["profiles"][0]))
            out["bad"] = [_admin(c, "profile", **q).status_code for q in (
                {"fmt": "bogus"}, {"breach": "nothing-stored"},
                {"seconds": "x"})]
            start = _admin(c, "profiling/start", profilerType="cpu")
            again = _admin(c, "profiling/start", profilerType="cpu")
            time.sleep(0.1)
            dl = _admin(c, "profiling/download")
            out["session"] = (start.status_code, sorted(start.json()),
                              again.status_code, dl.status_code,
                              dl.headers["Content-Disposition"],
                              dl.content.split(b"\n")[1],
                              _admin(c, "profiling/download").status_code,
                              _admin(c, "profiling/start",
                                     profilerType="gpu").status_code)
            th = _admin(c, "profiling/threads")
            out["threads"] = (th.status_code,
                              th.content.startswith(b"--- thread "))
            locks = _admin(c, "top/locks")
            out["top/locks"] = (locks.status_code, locks.json())
        finally:
            s.close()
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"]["top"][0] == 200
    assert got["port"]["bad"] == [400, 404, 400]
    assert got["port"]["session"][:4] == (200, ["kind", "started_at"], 400,
                                          200)
