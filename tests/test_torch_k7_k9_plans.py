"""The host-side plans of K7 (the 2-D diffusion whole run) and K9 (the
fused ADR stage): hand-counted cases of ``fused_diffusion2d.
diffusion2d_schedule`` (tiles, jobs, residency, patches a stage, shared
memory) and of ``fused_adr.adr_schedule`` / ``copy_floats`` (z chunks,
blocks, the width of the asynchronous copies a row pitch allows). Pure
Python: no CUDA device is needed."""

import pytest

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_adr as fa
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_diffusion2d as fd2,
)

# An H100 SXM's numbers as K7's C entry reads them (card_limits): 132
# SMs, one 640-thread block of 96 registers a thread an SM, 227 KB of
# shared memory a block may opt into, 228 KB an SM, 1 KB reserved a block.
H100 = dict(sms=132, blocks_per_sm=1, smem_block=232_448, smem_sm=233_472,
            smem_reserved=1024)

# (ny, nx, sms, tiles) -> the plan's counts. Hand counts (V = 4 rows a
# patch, quads in the window's coordinates, first window column at shared
# column 4):
#  - 23x37 in one tile: stages evaluate the whole interior (clipped), 23
#    rows = 6 patch rows, x 0..36 at shared columns 6..42 = quads 1..10;
#    window 27x41, pitch 4 * (44 // 4 + 3) = 56, 3 planes of 31 rows.
#  - 1001^2 on 132 SMs: 12x11 tiles of 84x91 (83 or 84 rows, 91 columns);
#    stage 1 a middle tile's 92 rows = 23 patch rows, its 99 columns at
#    shared columns 6..104 = 26 quads; stage 2: 22 x 24; stage 3: 21 x 24;
#    window 96x103, pitch 116, 3 planes of 100 rows.
#  - 40^2 on 2 SMs in 2x2 tiles of 20: 4 jobs on 2 blocks (not resident,
#    2 rounds); stage 1 24 rows (6 patch rows) x 7 quads, stage 2 22 (6)
#    x 6, stage 3 20 (5) x 6; cost 2 x (1 + 1 + 1 + RELOAD_ROUNDS).
#  - 40^2 on 2 SMs planned: 2x1 tiles (20x40) cost 3 as 1x1 and 1x2 do,
#    with the fewest patches, (6 + 6 + 5) x 11 quads.
K7_PLANS = {
    "one-tile": ((23, 37, 132, (1, 1)), dict(
        tiles=(1, 1), tile=(23, 37), jobs=1, blocks=1, resident=True,
        rounds=1, patches=(60, 60, 60), cost=3,
        smem_bytes=3 * 31 * 56 * 4)),
    "1001sq-planned": ((1001, 1001, 132, None), dict(
        tiles=(12, 11), tile=(84, 91), jobs=132, blocks=132, resident=True,
        rounds=1, patches=(598, 528, 504), cost=3,
        smem_bytes=3 * 100 * 116 * 4)),
    "streaming": ((40, 40, 2, (2, 2)), dict(
        tiles=(2, 2), tile=(20, 20), jobs=4, blocks=2, resident=False,
        rounds=2, patches=(42, 36, 30), cost=8,
        smem_bytes=3 * 36 * 44 * 4)),
    "40sq-planned": ((40, 40, 2, None), dict(
        tiles=(2, 1), tile=(20, 40), jobs=2, blocks=2, resident=True,
        rounds=1, patches=(66, 66, 55), cost=3,
        smem_bytes=3 * 36 * 56 * 4)),
}


@pytest.mark.parametrize("case", list(K7_PLANS))
def test_diffusion2d_schedule_hand_counted(case):
    (ny, nx, sms, tiles), want = K7_PLANS[case]
    card = {**H100, "sms": sms}
    assert fd2.diffusion2d_schedule(ny, nx, **card, tiles=tiles) == want


@pytest.mark.parametrize("shape,tiles", [
    ((23, 37), (4, 1)),   # 23 // 4 = 5 rows: a halo would reach 2 tiles
    ((23, 37), (1, 7)),   # 37 // 7 = 5 columns
    ((5, 70), (2, 1)),    # more tiles than 6-row sides
])
def test_diffusion2d_schedule_rejects_thin_tiles(shape, tiles):
    with pytest.raises(ValueError, match="6 cells"):
        fd2.diffusion2d_schedule(*shape, **H100, tiles=tiles)


def test_diffusion2d_schedule_shared_memory_bound():
    """One 1472^2 tile would need 3 planes of 1480 x 1488 floats; the
    planner's choice for the largest grids fits a block and runs every
    job's window through shared memory (2 rounds of jobs)."""
    with pytest.raises(ValueError, match="shared memory"):
        fd2.diffusion2d_schedule(1472, 1472, **H100, tiles=(1, 1))
    plan = fd2.diffusion2d_schedule(1472, 1472, **H100)
    assert plan["smem_bytes"] <= H100["smem_block"]
    assert plan["jobs"] > 132 and not plan["resident"]
    assert plan["rounds"] == 2


# (card, tiles) -> blocks and cost of 40^2 on 2 SMs, as the occupancy
# query counts blocks: 2x2 tiles hold 19,008 B of shared memory (20,096
# with the reserve, in 128-byte granules), so 3 blocks an SM fit: 4 jobs
# resident on 4 blocks, 2 taking turns on an SM, cost 2 x (1 + 1 + 1);
# a card with 40,000 B an SM keeps 1 block an SM: 2 blocks, 2 rounds.
K7_OCCUPANCY = {
    "three-an-sm": ({**H100, "sms": 2, "blocks_per_sm": 3},
                    dict(blocks=4, resident=True, rounds=1, cost=6)),
    "smem-bound": ({**H100, "sms": 2, "blocks_per_sm": 3,
                    "smem_sm": 40_000},
                   dict(blocks=2, resident=False, rounds=2, cost=8)),
}


@pytest.mark.parametrize("case", list(K7_OCCUPANCY))
def test_diffusion2d_schedule_blocks_as_occupancy(case):
    card, want = K7_OCCUPANCY[case]
    plan = fd2.diffusion2d_schedule(40, 40, **card, tiles=(2, 2))
    assert {k: plan[k] for k in want} == want


# (shape, zchunk) -> counts, in 16x64 tiles: 508x204x160 is 8 x 13 =
# 104 tiles; 160 planes in ceil(160 / 6) = 27 chunks of 6 (the last 4):
# 2,808 blocks; an explicit chunk of 16: 10 chunks, of 4: 40 chunks;
# 29x37 is 2 x 1 tiles, its 23 planes 4 chunks of 6 (the last 5).
K9_PLANS = {
    "main-planned": (((160, 204, 508), None), dict(
        tile_shape=(16, 64), tiles=104, chunk_planes=6, chunks=27,
        blocks=2808)),
    "main-zchunk4": (((160, 204, 508), 4), dict(
        tile_shape=(16, 64), tiles=104, chunk_planes=4, chunks=40,
        blocks=4160)),
    "main-zchunk16": (((160, 204, 508), 16), dict(
        tile_shape=(16, 64), tiles=104, chunk_planes=16, chunks=10,
        blocks=1040)),
    "odd-planned": (((23, 29, 37), None), dict(
        tile_shape=(16, 64), tiles=2, chunk_planes=6, chunks=4,
        blocks=8)),
}


@pytest.mark.parametrize("case", list(K9_PLANS))
def test_adr_schedule_hand_counted(case):
    (shape, zchunk), want = K9_PLANS[case]
    got = fa.adr_schedule(shape, 528, zchunk=zchunk)
    assert {k: got[k] for k in want} == want
    assert got["waves"] == want["blocks"] / 528


@pytest.mark.parametrize("nx,want", [
    (508, 4),  # pitch 512: 16-byte copies
    (60, 4),   # pitch 64
    (70, 1),   # pitch 74: 4-byte copies
    (37, 1),   # pitch 41
])
def test_copy_floats_by_pitch(nx, want):
    assert fa.copy_floats(nx) == want
    assert fa.adr_schedule((8, 8, nx), 528)["copy_floats"] == want
