"""The CTA geometry of the two bitrot-hash kernels, K3 (csrc/mur3x256.cu)
and K5 (csrc/highwayhash.cu): ``hh_cuda.launch_plan`` must cover every chunk
exactly once under the kernels' split of n chunks over the grid, fit the
ring in a CTA's shared memory with rows a bulk copy can take, and reach
every SM whenever n allows. Pure Python: no card needed.
"""
import pytest

from minio_tpu_torch.ops import hh_cuda

COUNTS = [1, 2, 3, 131, 132, 133, 256, 257, 1024, 2560, 10240, 20480]
#: tile edges (16, 32, 48, 496, 512, 528), the paths' 16 KiB chunks, and
#: K5's lengths with a remainder past the last packet (4, 28, 36, 1,028)
NBYTES = [16, 32, 48, 496, 512, 528, 1024, 16384, 16416, 4, 28, 36, 1028]


def cta_ranges(n, grid):
    """The chunks of each CTA, as csrc/chunk_ring.cuh cta_chunks splits
    them: [b*n//grid, (b+1)*n//grid)."""
    return [(b * n // grid, (b + 1) * n // grid) for b in range(grid)]


def check_plan(plan, n, nbytes, bulk, sms):
    ranges = cta_ranges(n, plan.grid)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(1 <= e - s <= plan.chunks_per_cta for s, e in ranges)
    assert plan.grid >= min(n, sms)
    assert plan.threads % 32 == 0 and plan.threads <= 544
    assert plan.threads >= 2 * plan.chunks_per_cta + (32 if bulk else 0)
    # two CTAs per SM, each within a CTA's most (232,448 bytes on Hopper)
    assert plan.smem_bytes <= hh_cuda.CTA_SMEM <= 232_448
    if bulk:
        assert plan.tile_bytes % 16 == 0 and plan.tile_bytes > 0
        # the ring: header, stages x chunks x pitch; rows 32 mod 128 apart
        assert plan.smem_bytes == hh_cuda.RING_HEADER + (
            plan.stages * plan.chunks_per_cta * plan.pitch)
        assert plan.pitch % 128 == 32 and plan.pitch >= plan.tile_bytes
        assert 1 <= plan.stages <= 8
        # double-buffered unless the chunk is a single tile
        assert plan.stages >= min(2, -(-nbytes // plan.tile_bytes))
        if nbytes > plan.tile_bytes:  # K5's tiles hold whole packets
            assert plan.tile_bytes % 32 == 0
    else:
        assert plan.smem_bytes == plan.stages == 0


@pytest.mark.parametrize("nbytes", NBYTES)
@pytest.mark.parametrize("n", COUNTS)
def test_plan_covers_fits_and_spreads(n, nbytes):
    bulk = nbytes % 16 == 0
    check_plan(hh_cuda.launch_plan(n, nbytes, bulk), n, nbytes, bulk,
               hh_cuda.SMS)


@pytest.mark.parametrize("n", [1, 133, 10240, 100_000])
@pytest.mark.parametrize("sms", [114, 132])
def test_plan_on_other_cards_and_unaligned_rows(n, sms):
    # a card with other SM counts, and 16 KiB rows a bulk copy cannot take
    # (an unaligned view: the direct-load case)
    for bulk in (True, False):
        check_plan(hh_cuda.launch_plan(n, 16384, bulk, sms), n, 16384, bulk,
                   sms)


def test_plan_at_the_flush_shapes():
    # two CTAs per SM: at 10,240 chunks 39 each, two stages of 1 KiB tiles
    big = hh_cuda.launch_plan(10240, 16384)
    assert (big.grid, big.chunks_per_cta, big.stages, big.tile_bytes,
            big.pitch) == (264, 39, 2, 1024, 1056)
    # a verify flush: one chunk per CTA, the whole 16 KiB chunk in flight
    small = hh_cuda.launch_plan(256, 16384)
    assert (small.grid, small.chunks_per_cta, small.stages,
            small.tile_bytes) == (256, 1, 4, 4096)
    # past what one wave of CTAs holds (106 chunks each), whole extra waves
    assert hh_cuda.launch_plan(60000, 16384).grid == 3 * 264


def test_plan_refuses_no_work():
    with pytest.raises(ValueError):
        hh_cuda.launch_plan(0, 16384)
    with pytest.raises(ValueError):
        hh_cuda.launch_plan(4, 0)


def test_launch_sizes_bucket_by_powers_of_two():
    counts, sizes = {"k": 0}, {"k": {}}
    for n in (1, 2, 3, 256, 257, 10240):
        hh_cuda.count_launch(counts, sizes, "k", n)
    assert counts == {"k": 6}
    assert sizes == {"k": {1: 1, 2: 1, 4: 1, 256: 1, 512: 1, 16384: 1}}
