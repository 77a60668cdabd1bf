"""The port's observability plane (minio_tpu_torch.obs) held to the JAX
package's (minio_tpu.obs) on the same inputs, made from a numpy seed:
the last-minute latency window, stage attribution, the flight recorder
(snapshot, Chrome export, lane busy ratio), traceparent parsing and span
trees; then the hooks on the CPU queue and the object layer: the same
flush events and one kernel span per flush linked to each item, the same
stage names for put/get/heal, and the device plane's ledger balanced
after a drain, with the card's busy share and roofline ratio null on the
CPU. Exact equality unless a test says otherwise."""
import io
import json
import os
import shutil

import numpy as np
import pytest

from minio_tpu.obs import attribution as jattr
from minio_tpu.obs import latency as jlat
from minio_tpu.obs import spans as jspans
from minio_tpu.obs import stages as jstages
from minio_tpu.obs import timeline as jtl
from minio_tpu_torch.obs import attribution as pattr
from minio_tpu_torch.obs import device as pdev
from minio_tpu_torch.obs import latency as plat
from minio_tpu_torch.obs import spans as pspans
from minio_tpu_torch.obs import stages as pstages
from minio_tpu_torch.obs import timeline as ptl

SEED = 20261017
TL_ENV = ("MINIO_TPU_TIMELINE", "MINIO_TPU_TIMELINE_RING",
          "MINIO_TPU_TIMELINE_SAMPLE")


@pytest.fixture
def fresh(monkeypatch):
    """Both recorders and attribution stores empty, default switches."""
    for k in TL_ENV:
        monkeypatch.delenv(k, raising=False)
    for tl, attr in ((jtl, jattr), (ptl, pattr)):
        tl.configure()
        tl.reset()
        attr.reset()
    yield
    for tl, attr in ((jtl, jattr), (ptl, pattr)):
        tl.configure()
        tl.reset()
        attr.reset()


# -- latency.Window -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_window_matches(seed):
    """Same observations at the same explicit ``now``s: the same
    percentiles, rates, histogram, worst sample and mean, also after
    slots expire."""
    rng = np.random.default_rng(SEED + seed)
    secs = rng.lognormal(-5.0, 1.5, 400)
    nbytes = rng.integers(0, 1 << 22, 400)
    nows = np.sort(rng.uniform(1000.0, 1100.0, 400))
    jw, pw = jlat.Window(), plat.Window()
    for s, b, t, i in zip(secs, nbytes, nows, range(400)):
        jw.observe(float(s), int(b), now=float(t), trace_id=f"t{i}")
        pw.observe(float(s), int(b), now=float(t), trace_id=f"t{i}")
    for now in (1050.0, 1100.0, 1140.0, 1200.0):
        qs = (0.5, 0.9, 0.95, 0.99, 0.999)
        assert pw.stats(qs, now=now) == jw.stats(qs, now=now)
        assert pw.hist(now=now) == jw.hist(now=now)
        assert pw.percentiles(qs, now=now) == jw.percentiles(qs, now=now)
        assert pw.rate_gibs(now=now) == jw.rate_gibs(now=now)
        assert pw.mean(now=now) == jw.mean(now=now)
        assert pw.worst(now=now) == jw.worst(now=now)
        assert pw.count(now=now) == jw.count(now=now)
    assert plat.EDGES == jlat.EDGES and plat.HIST_EDGES == jlat.HIST_EDGES


# -- stages and attribution ---------------------------------------------------


def test_attribution_report_matches(fresh):
    """The same stage charges give the same standing report (per-stage
    p50/p99, seconds and share of wall); chaining to an outer collector
    feeds it the same seconds."""
    rng = np.random.default_rng(SEED)
    stages = ("body_read", "encode_hash", "shard_write", "etag")
    charges = [(op, [(st, float(rng.uniform(1e-4, 5e-2)))
                     for st in stages if rng.random() < 0.8],
                float(rng.uniform(0.05, 0.2)))
               for op in ("put", "get", "heal") for _ in range(20)]
    outers = []
    for stg, attr in ((jstages, jattr), (pstages, pattr)):
        with stg.collect() as outer:
            for op, adds, wall in charges:
                st = stg.StageTimes(parent=outer)
                for name, dt in adds:
                    st.add(name, dt)
                attr.record(op, st, wall)
        outers.append(outer.snapshot())
    assert outers[0] == outers[1]
    assert pattr.report() == jattr.report()


def test_attribution_follows_the_recorder_switch(fresh, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TIMELINE", "0")
    ptl.configure()
    with pattr.observed("put") as st:
        assert st is None
    assert pattr.report() == {}


# -- the flight recorder ------------------------------------------------------


def _record_sequence(tl, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for fid in range(1, 41):
        lane = ("bulk", "interactive")[int(rng.integers(0, 2))]
        op = ("encode_hashed", "reconstruct", "fused")[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 9))
        tl.record("enqueue", op=op, trace_id=f"{fid:032x}", bytes=n * 4096,
                  stream=lane)
        tl.record("flush_start", op=op, lane=lane, flush_id=fid, batch=n,
                  capacity=8, bytes=n * 4096, route="cpu", stream=lane)
        if fid % 7:
            tl.record("flush_end", op=op, lane=lane, flush_id=fid, batch=n,
                      capacity=8, bytes=n * 8192, route="cpu", stream=lane,
                      dur=float(rng.uniform(1e-4, 1e-2)))
        tl.record("complete", op=op, wall=0.001, stream=lane)
        if fid % 11 == 0:
            tl.record("salvage", op=op, lane="cpu", reason="launch", batch=n)


def _strip_ts(x):
    if isinstance(x, dict):
        return {k: _strip_ts(v) for k, v in x.items() if k not in ("ts",)}
    if isinstance(x, list):
        return [_strip_ts(v) for v in x]
    return x


def _chrome_key(ev: dict) -> tuple:
    return (ev.get("ph"), ev.get("name"), ev.get("pid"),
            json.dumps(ev.get("args", {}), sort_keys=True))


@pytest.mark.parametrize("ring", ["8192", "64"])
def test_timeline_snapshot_and_chrome_export_match(fresh, monkeypatch,
                                                    ring):
    """The same record sequence: the same events (timestamps aside), the
    same drop count when the ring overflows, the same Chrome export
    (timestamps and durations aside) and the same lane accounting."""
    monkeypatch.setenv("MINIO_TPU_TIMELINE_RING", ring)
    for tl in (jtl, ptl):
        tl.configure()
        tl.reset()
        _record_sequence(tl, SEED)
    assert _strip_ts(ptl.snapshot()) == _strip_ts(jtl.snapshot())
    assert ptl.dropped_total() == jtl.dropped_total()
    assert ptl.status() == jtl.status()
    jc, pc = jtl.export_chrome(), ptl.export_chrome()
    assert sorted(map(_chrome_key, pc["traceEvents"])) == \
        sorted(map(_chrome_key, jc["traceEvents"]))
    assert pc["otherData"] == jc["otherData"]
    ju, pu = jtl.utilization(), ptl.utilization()
    for u in (ju, pu):
        for st in u["lanes"].values():
            st.pop("busy_ratio")  # integrates on the recorders' own clocks
    assert pu == ju


def test_lane_busy_ratio_matches_at_faked_times(fresh):
    """Flushes noted at explicit times integrate to the same busy ratio,
    the window's expiry and the overlong-flush clamp included."""
    rng = np.random.default_rng(SEED)
    flushes = [(float(rng.uniform(0.0, 3.0)), int(rng.integers(1, 9)),
                float(t)) for t in np.sort(rng.uniform(500.0, 600.0, 60))]
    flushes.append((90.0, 8, 620.0))  # longer than the window
    lanes = []
    for tl in (jtl, ptl):
        st = tl._lane("bulk")
        for dur, batch, now in flushes:
            st.note_flush(dur, batch, 8, batch * 4096, now)
        lanes.append(st)
    for now in (560.0, 600.0, 621.0, 650.0, 700.0):
        assert lanes[1].busy_ratio(now) == lanes[0].busy_ratio(now)
        assert lanes[1].snapshot(now) == lanes[0].snapshot(now)


def test_queue_depth_distribution_matches(fresh):
    for tl in (jtl, ptl):
        for d in np.random.default_rng(SEED).integers(0, 700, 200):
            tl.note_queue_depth(int(d))
    for q in (0.5, 0.9, 0.99):
        assert ptl.queue_depth_percentile(q) == \
            jtl.queue_depth_percentile(q)


# -- spans --------------------------------------------------------------------

TRACEPARENTS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0123456789abcdef" * 2 + "-" + "fedcba9876543210" + "-00",
    " 00-" + "1" * 32 + "-" + "2" * 16 + "-01 ",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-01",       # version
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",       # short trace id
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",       # short span id
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",       # not hex
    "00-" + "a" * 32 + "-" + "b" * 16,               # three fields
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-x",     # five fields
    "", "garbage", None,
]


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_traceparent_round_trips_alike(value):
    j, p = jspans.parse_traceparent(value), pspans.parse_traceparent(value)
    assert (p is None) == (j is None)
    if p is not None:
        assert (p.trace_id, p.span_id, p.sampled) == \
            (j.trace_id, j.span_id, j.sampled)
        assert pspans.to_traceparent(p) == jspans.to_traceparent(j)


def _span_forest(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    spans = [{"span_id": "root", "parent_span_id": "", "name": "s3",
              "time": 0.0}]
    for i in range(40):
        parent = spans[int(rng.integers(0, len(spans)))]["span_id"] \
            if rng.random() < 0.9 else f"absent{i}"
        spans.append({"span_id": f"s{i}", "parent_span_id": parent,
                      "name": f"n{i}", "time": float(rng.uniform(0, 10))})
    return spans


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_builds_the_same_trees(seed):
    spans = _span_forest(SEED + seed)
    assert pspans.assemble(spans) == jspans.assemble(spans)


# -- the hooks on the CPU queue -----------------------------------------------


def _encode_items(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 4096), dtype=np.uint8)
            for _ in range(n)]


def _flush_events(evs: list, lane_of) -> list[tuple]:
    return sorted((e["type"], e["op"], e["batch"], lane_of(e))
                  for e in evs if e["type"] in ("flush_start", "flush_end"))


def test_cpu_queue_flush_events_match_jax(fresh, monkeypatch):
    """The same submits on a CPU queue of each package (every bucket
    filled to its batch before any deadline): the same event types (the
    JAX queue's ``plan``, its QoS scheduler's, aside), op names, batch
    sizes and lanes — the JAX queue's ``stream`` is the port's lane —
    and one kernel span per flush in the request's trace, linked to every
    coalesced item."""
    from minio_tpu.ops.rs_jax import get_codec as jcodec
    from minio_tpu.ops.rs_jax import pack_shards as jpack
    from minio_tpu.runtime.dispatch import DispatchQueue as JQueue
    from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    monkeypatch.setenv("MINIO_TPU_DISPATCH_MODE", "cpu")
    datas = _encode_items(12, SEED)
    runs = {}
    for name, make, codec, pack, spans, tl in (
            ("jax", lambda: JQueue(max_batch=4, max_delay=30.0),
             jcodec(4, 2), jpack, jspans, jtl),
            ("port", lambda: DispatchQueue("cpu", max_batch=4,
                                           max_delay=30.0),
             get_codec(4, 2, device="cpu"), pack_shards, pspans, ptl)):
        tl.reset()
        q = make()
        tid = spans.new_trace_id()
        ctx, tok = spans.begin_request(tid)
        try:
            futs = [q.encode(codec, pack(d)) for d in datas]
            for f in futs:
                f.result(timeout=60)
        finally:
            q.stop()
            recorded = list(spans._active.get(tid, {}).get("spans", []))
            spans.finish_request(ctx, tok, name="t", duration_s=0.0)
        runs[name] = (tl.snapshot(), recorded, ctx)
    jevs, _, _ = runs["jax"]
    pevs, pspan_list, pctx = runs["port"]
    assert {e["type"] for e in pevs} == \
        {e["type"] for e in jevs} - {"plan"}
    assert _flush_events(pevs, lambda e: e["lanes"][0]) == \
        _flush_events(jevs, lambda e: e["stream"])
    assert [(e["op"], e["stream"]) for e in pevs if e["type"] == "enqueue"] \
        == [(e["op"], e["stream"]) for e in jevs if e["type"] == "enqueue"]
    kernel = [s for s in pspan_list if s["name"].startswith("kernel.")]
    flushes = [e for e in pevs if e["type"] == "flush_end"]
    assert len(kernel) == len(flushes) == 3
    for s in kernel:
        assert s["parent_span_id"] == pctx.span_id
        assert s["links"] == [{"trace_id": pctx.trace_id,
                               "span_id": pctx.span_id}]
        assert s["attrs"]["batch"] == 4 and s["attrs"]["items"] == 4


def test_cpu_queue_ledger_balances_and_device_numbers_are_null(fresh):
    """On a CPU queue every flush charges the ledger and releases it when
    its results land; no CUDA event exists, so the streams' occupancy and
    the roofline ratio are null."""
    from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    pdev.reset()
    codec = get_codec(4, 2, device="cpu")
    q = DispatchQueue("cpu", max_batch=4, max_delay=0.01)
    try:
        futs = [q.encode(codec, pack_shards(d))
                for d in _encode_items(10, SEED + 1)]
        for f in futs:
            f.result(timeout=60)
    finally:
        q.stop()
    st = pdev.status()
    assert st["ledger_balanced"] and pdev.ledger_balanced()
    led = st["ledger"]["bulk"]
    assert led["acquired_total"] == led["released_total"] >= 3
    assert led["peak_bytes"] > 0
    assert st["roofline"] == {} and pdev.roofline_gibs() is None
    assert st["stream_occupancy"] == {"": {
        "window_s": 60, "union_share": None, "union_seconds_total": None,
        "lanes": {}}}
    assert pdev.occupancy_share({}, pdev.occupancy_totals(), 1.0) == {
        "": {"union": None, "lanes": {}}}
    assert st["device_memory"] == []
    comp = st["compile"]
    assert comp["compiles_total"] == 0
    assert comp["first_launches_total"] >= 1
    assert comp["launches_total"] == q.stats()["batches"]


def test_busy_union_of_overlapping_lanes():
    """The union of the two lanes' intervals on the card's clock counts
    overlapping time once; each lane keeps its own seconds."""
    b = pdev._Intervals()
    for lane, s, e in (("bulk", 0.0, 1.0), ("interactive", 0.5, 1.5),
                       ("bulk", 2.0, 2.5), ("interactive", 2.4, 2.45),
                       ("bulk", 1.4, 1.6)):
        b.add(lane, s, e, now=100.0)
    assert b.lanes == pytest.approx({"bulk": 1.7, "interactive": 1.05})
    assert b.union_s == pytest.approx(2.1)
    assert b.merged == [[0.0, 1.6], [2.0, 2.5]]
    assert 0.0 < b.share("union", 100.0) <= 1.0


def test_occupancy_share_is_not_clamped():
    """A window's share is the covered seconds over the window, never
    clamped to 1, so an overcount (intervals of one stream that overlap)
    shows instead of reading as a full stream."""
    b = pdev._Intervals()
    b.add("bulk", 0.0, 45.0, now=100.0)
    b.add("bulk", 10.0, 55.0, now=100.0)
    assert b.share("bulk", 100.0) == pytest.approx(1.5)
    assert b.share("union", 100.0) == pytest.approx(55.0 / 60)


def test_storage_instrument_failure_keeps_the_disk_result(tmp_path,
                                                          monkeypatch):
    """A storage-call instrument that raises never replaces the disk
    call's result: the call returns as without the plane, and the failure
    is counted."""
    from minio_tpu_torch.storage import xlstorage

    def broken(*a, **kw):
        raise RuntimeError("instrument down")

    disk = xlstorage.XLStorage(str(tmp_path / "d0"))
    disk.make_vol("b")
    before = xlstorage.obs_errors()
    monkeypatch.setattr(xlstorage._lat, "observe", broken)
    disk.write_all("b", "x", b"payload")
    assert disk.read_all("b", "x") == b"payload"
    assert xlstorage.obs_errors() >= before + 2


# -- the hooks in the object layer --------------------------------------------


def _stage_names(rep: dict) -> dict:
    return {op: sorted(ent["stages"]) for op, ent in rep.items()}


def test_object_layer_charges_the_jax_stage_names(fresh, monkeypatch,
                                                  tmp_path):
    """put/get/heal of the same objects on each package's CPU object layer
    (the JAX package on its dispatch routes, the port's only ones) charge
    the same stage names, but for the healthy GET's queue wait, and both
    report every op."""
    from minio_tpu.objectlayer import ErasureObjects as JObjects
    from minio_tpu.storage.xlstorage import XLStorage as JXLStorage
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.storage.xlstorage import XLStorage
    monkeypatch.setenv("MINIO_TPU_DISPATCH_MODE", "cpu")
    monkeypatch.setenv("MINIO_TPU_PUT_PATH", "dispatch")
    monkeypatch.setenv("MINIO_TPU_GET_PATH", "dispatch")
    body = np.random.default_rng(SEED).integers(
        0, 256, 200_003, dtype=np.uint8).tobytes()
    reports = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        if name == "jax":
            layer = JObjects([JXLStorage(str(root / f"d{i}"))
                              for i in range(6)], default_parity=2,
                             block_size=1 << 16)
            attr = jattr
        else:
            layer = ErasureObjects([XLStorage(str(root / f"d{i}"))
                                    for i in range(6)], default_parity=2,
                                   block_size=1 << 16, device="cpu")
            attr = pattr
        layer.make_bucket("b")
        layer.put_object("b", "o", io.BytesIO(body), len(body))
        assert layer.get_object_bytes("b", "o") == body
        shutil.rmtree(root / "d0" / "b" / "o")
        layer.heal_object("b", "o")
        reports[name] = attr.report()
    want = _stage_names(reports["jax"])
    # the one difference of route: the JAX package verifies a healthy
    # GET's digests on the host, the port on the device (the ``verify``
    # op), so the port's GET also waits on the queue
    want["get"] = sorted(set(want["get"]) | {"queue_wait"})
    assert _stage_names(reports["port"]) == want
    for rep in reports.values():
        assert {"put", "get", "heal"} <= set(rep)
        assert rep["heal"]["stages"]["rebuild"]["seconds_total"] > 0


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    """One bounded torch.profiler session (admin ``device?trace=<s>``):
    a Chrome trace in a fresh directory, one session at a time."""
    out = pdev.capture_trace(0.05)
    try:
        assert out["files"] == ["trace.json"]
        path = os.path.join(out["logdir"], "trace.json")
        with open(path) as f:
            assert "traceEvents" in json.load(f)
        assert 0.05 <= out["seconds"] < 30
        # no card: no activity of one, and no busy share of it
        assert out["device_busy_share"] is None
        assert out["device_idle_share"] is None
    finally:
        shutil.rmtree(out["logdir"], ignore_errors=True)
