"""The port's multi-lane MD5 server (minio_tpu_torch.utils.md5simd, on the
port's libnative.so) and the HashReader routes that feed it, held to
hashlib and to the JAX package's server (minio_tpu.utils.md5simd) on the
same numpy-made inputs: digests at odd buffer boundaries, many streams at
once, the refusal of an update after the digest, the bounded queue, and
the lane route of MD5-only bodies of at least 4 MiB (the ETag of a
compressed PUT)."""
import hashlib
import io
import threading

import numpy as np
import pytest

from minio_tpu.utils import md5simd as jmd5
from minio_tpu_torch.utils import errors
from minio_tpu_torch.utils import hashreader as phr
from minio_tpu_torch.utils import md5simd as pmd5

SEED = 20261018


@pytest.fixture(scope="module")
def srv():
    return pmd5.global_server()


def _bytes(n: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + n + tag).integers(
        0, 256, n, dtype=np.uint8).tobytes()


CASES = {
    "empty": [b""],
    "one byte": [b"a"],
    "one block": [b"x" * 64],
    "55+9+130": [b"x" * 55, b"y" * 9, b"z" * 130],
    "63+65": [b"q" * 63, b"r" * 65],
    "odd sizes": [_bytes(n) for n in (1, 63, 64, 65, 1000, 100_000,
                                      1 << 20)],
    "memoryviews": [memoryview(_bytes(70_001, 1))[3:], _bytes(5, 2)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_digests_equal_hashlib_and_the_jax_server(srv, case):
    chunks = CASES[case]
    s, ref = srv.stream(), hashlib.md5()
    j = jmd5.global_server().stream()
    for c in chunks:
        s.update(c)
        j.update(bytes(c))
        ref.update(c)
    assert s.hexdigest() == ref.hexdigest() == j.hexdigest()
    assert s.digest() == ref.digest()


def test_concurrent_streams_share_the_lanes(srv):
    """Nine streams at once, each cut at its own odd boundaries; every
    digest equals hashlib's, and rounds ran with more than one lane."""
    before = list(srv.lane_rounds)
    outs, want = {}, {}

    def one(j):
        data = _bytes((1 << 20) + 37 * j, j)
        want[j] = hashlib.md5(data).hexdigest()
        s = srv.stream()
        step = 65_536 + 13 * j
        for off in range(0, len(data), step):
            s.update(data[off:off + step])
        outs[j] = s.hexdigest()

    threads = [threading.Thread(target=one, args=(j,)) for j in range(9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert outs == want
    rounds = [a - b for a, b in zip(srv.lane_rounds, before)]
    assert sum(rounds) > 0
    st = srv.stats()
    assert st["rounds"] == sum(srv.lane_rounds)
    assert st["streams_per_round"] >= 1.0


def test_update_after_digest_refused(srv):
    s = srv.stream()
    s.update(b"abc")
    assert s.hexdigest() == hashlib.md5(b"abc").hexdigest()
    with pytest.raises(ValueError):
        s.update(b"more")


def test_backpressure_bounds_the_queue(srv):
    s = srv.stream()
    big = b"\x00" * (1 << 20)
    for _ in range(64):  # 64 MiB through an 8 MiB queue cap
        s.update(big)
        assert s._qbytes <= pmd5.MD5Stream.MAX_QUEUED + len(big)
    assert s.hexdigest() == hashlib.md5(big * 64).hexdigest()


def test_hashreader_takes_the_lanes_for_large_md5_only_bodies(
        srv, monkeypatch):
    from minio_tpu.utils import hashreader as jhr
    monkeypatch.setattr(phr, "_MULTI_CORE", True)
    monkeypatch.setattr(jhr, "_MULTI_CORE", True)
    body = _bytes(phr.ASYNC_DIGEST_MIN + 4097, 3)
    want = hashlib.md5(body).hexdigest()
    hr = phr.HashReader(io.BytesIO(body), len(body))
    assert isinstance(hr._md5, pmd5.MD5Stream) and hr._lane
    # readinto goes through read() and a copy while the lanes hold input
    buf = bytearray(1 << 20)
    got = bytearray()
    while (n := hr.readinto(buf)):
        got += buf[:n]
    assert bytes(got) == body
    j = jhr.HashReader(io.BytesIO(body), len(body))
    while j.read(1 << 20):
        pass
    assert hr.etag() == want == j.etag()
    # a body under the threshold, and one that also needs SHA256, keep
    # hashlib (the latter on a digest worker)
    small = phr.HashReader(io.BytesIO(body[:phr.ASYNC_DIGEST_MIN - 1]),
                           phr.ASYNC_DIGEST_MIN - 1)
    assert not small._lane and small._async is None
    sha = hashlib.sha256(body).hexdigest()
    hr2 = phr.HashReader(io.BytesIO(body), len(body), sha256_hex=sha)
    assert not hr2._lane and hr2._async is not None
    while hr2.read(1 << 20):
        pass
    assert hr2.etag() == want


def test_unknown_size_body_moves_to_a_worker(monkeypatch):
    monkeypatch.setattr(phr, "_MULTI_CORE", True)
    body = _bytes(phr.ASYNC_DIGEST_MIN + 100, 4)
    hr = phr.HashReader(io.BytesIO(body), -1)
    while hr.read(1 << 20):
        pass
    assert hr._active_token == {}  # released at EOF
    assert hr.etag() == hashlib.md5(body).hexdigest()


def test_readinto_without_a_deferred_digest_fills_the_buffer_in_place():
    """The zero-copy leg: with the payload hash off (the fused ETag) or
    inline, readinto fills the caller's buffer from the inner stream's
    readinto; the declared size is enforced."""
    body = _bytes(300_000, 5)
    hr = phr.HashReader(io.BytesIO(body), len(body))
    assert hr.disable_payload_hash()
    arr = np.empty(1 << 17, np.uint8)
    got = bytearray()
    while (n := hr.readinto(arr)):
        got += arr[:n].tobytes()
    assert bytes(got) == body
    inline = phr.HashReader(io.BytesIO(body), len(body))
    while inline.readinto(arr):
        pass
    assert inline.etag() == hashlib.md5(body).hexdigest()
    short = phr.HashReader(io.BytesIO(body[:10]), 11)
    with pytest.raises(errors.LessData):
        while short.readinto(arr):
            pass
