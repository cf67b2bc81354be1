"""The host-side plans of K7 (the 2-D diffusion and Burgers whole runs)
and K9 (the fused ADR stage): hand-counted cases of ``fused_diffusion2d.
diffusion2d_schedule`` (tiles, jobs, residency, patches a stage, shared
memory), of ``fused_burgers2d.burgers2d_schedule`` and ``ops_issued``
(tiles, windows, jobs, residency, shared memory, the operations a step
issues) and of ``fused_adr.adr_schedule`` / ``copy_floats`` (z chunks,
blocks, the width of the asynchronous copies a row pitch allows). Pure
Python: no CUDA device is needed."""

import pytest

from multigpu_advectiondiffusion_tpu_torch.ops.kernels import fused_adr as fa
from multigpu_advectiondiffusion_tpu_torch.ops.kernels import (
    fused_burgers2d as fb2,
)
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


# K7 Burgers: (ny, nx, tiles) -> the plan's counts on the H100's numbers.
# Hand counts (windows 9 cells past a tile, clipped to 3 past the grid;
# 7 planes of the widest window and 2 spare rows and columns; a job's
# cost: 6 a loaded cell (resident: its halo), and a stage's runs of three
# faces, nr (nc // 3 + 1) x runs and nc (nr // 3 + 1) y runs on its nr x
# nc cells, 305 each (WENO5-JS), and its cells at 14 (stage 1) or 17:
# divergences 6, combine 2 or 5, the split of the result 6):
#  - 23x37 in one tile: window 29x43 (rows -3..25); smem 7 x 31 x 45 x 4;
#    halo 29 x 43 - 23 x 37 = 396 cells; every stage on 23x37: 23 x 13 +
#    37 x 8 = 595 runs; 2,376 + 3 x 181,475 + 851 x (14 + 17 + 17).
#  - 23x37 planned: 2x4 tiles of 12x10 (11 or 12 rows, 9 or 10 columns),
#    8 jobs resident; the largest job (rows 11..22, columns 9..17):
#    window 24x27, stages on 18x21, 15x15, 12x9: 540 x 6 + (144 + 147 +
#    90 + 90 + 48 + 45) x 305 + 378 x 14 + 225 x 17 + 108 x 17.
#  - 400^2 planned: 10x13 tiles of 40x31 (30 or 31 columns), 130 jobs
#    resident on 130 blocks; window 58x49, smem 7 x 60 x 51 x 4; an
#    interior job: stages on 52x43, 46x37, 40x31, 1,554 + 1,190 + 874
#    runs, halo 58 x 49 - 40 x 31 = 1,602 cells.
#  - 1478^2 planned: 22x24 tiles of 68x62, 528 jobs on 132 blocks (one
#    block an SM: 202,048 B of shared memory), 4 rounds, not resident.
#  - 5x70 planned: 1x7 tiles of 5x10, window 11x28 (rows -3..7).
K7B_PLANS = {
    "one-tile": ((23, 37, (1, 1)), dict(
        tiles=(1, 1), tile=(23, 37), window=(29, 43), jobs=1, blocks=1,
        resident=True, rounds=1,
        cost=2376 + 3 * 595 * 305 + 851 * (14 + 17 + 17),
        smem_bytes=7 * 31 * 45 * 4)),
    "23x37-planned": ((23, 37, None), dict(
        tiles=(2, 4), tile=(12, 10), window=(29, 28), jobs=8, blocks=8,
        resident=True, rounds=1,
        cost=540 * 6 + 564 * 305 + 378 * 14 + 225 * 17 + 108 * 17,
        smem_bytes=7 * 31 * 30 * 4)),
    "400sq-planned": ((400, 400, None), dict(
        tiles=(10, 13), tile=(40, 31), window=(58, 49), jobs=130,
        blocks=130, resident=True, rounds=1,
        cost=1602 * 6 + 3618 * 305 + 2236 * 14 + (1702 + 1240) * 17,
        smem_bytes=7 * 60 * 51 * 4)),
    "1478sq-planned": ((1478, 1478, None), dict(
        tiles=(22, 24), tile=(68, 62), window=(86, 80), jobs=528,
        blocks=132, resident=False, rounds=4, smem_bytes=7 * 88 * 82 * 4)),
    "5x70-planned": ((5, 70, None), dict(
        tiles=(1, 7), tile=(5, 10), window=(11, 28), jobs=7, blocks=7,
        resident=True, rounds=1, smem_bytes=7 * 13 * 30 * 4)),
}


@pytest.mark.parametrize("case", list(K7B_PLANS))
def test_burgers2d_schedule_hand_counted(case):
    (ny, nx, tiles), want = K7B_PLANS[case]
    plan = fb2.burgers2d_schedule(ny, nx, **H100, tiles=tiles)
    assert {k: plan[k] for k in want} == want
    assert plan["smem_bytes"] <= H100["smem_block"]


@pytest.mark.parametrize("shape,tiles", [
    ((23, 37), (3, 1)),   # 23 // 3 = 7 rows: thinner than a 9-cell halo
    ((23, 37), (1, 5)),   # 37 // 5 = 7 columns
    ((5, 70), (1, 8)),    # 70 // 8 = 8 columns
])
def test_burgers2d_schedule_rejects_thin_tiles(shape, tiles):
    with pytest.raises(ValueError, match="9 cells"):
        fb2.burgers2d_schedule(*shape, **H100, tiles=tiles)


def test_burgers2d_schedule_shared_memory_bound():
    """One 1478^2 tile would need 7 planes of 1486 x 1486 floats."""
    with pytest.raises(ValueError, match="shared memory"):
        fb2.burgers2d_schedule(1478, 1478, **H100, tiles=(1, 1))


@pytest.mark.parametrize("kw,want", [
    # one 23x37 tile, the cost's count
    (dict(viscous=False, variant="js", adaptive=False),
     2376 + 3 * 595 * 305 + 851 * (14 + 17 + 17)),
    # viscous (+20 a cell a stage), WENO5-Z (335 a run), adaptive (+2 a
    # cell of stage 3)
    (dict(viscous=True, variant="z", adaptive=True),
     2376 + 3 * 595 * 335 + 851 * (34 + 37 + 39)),
])
def test_burgers2d_ops_issued_hand_counted(kw, want):
    plan = fb2.burgers2d_schedule(23, 37, **H100, tiles=(1, 1))
    assert fb2.ops_issued(23, 37, plan, **kw) == want


def test_burgers2d_ops_issued_sums_every_job():
    """2x1 tiles of 11 and 12 rows of 37, not resident (one block): each
    job loads its whole window and does not split its stage-3 result."""
    card = {**H100, "sms": 1}
    plan = fb2.burgers2d_schedule(23, 37, **card, tiles=(2, 1))
    assert not plan["resident"]
    # rows 0..10: window -3..19 (23 rows), stages on 17, 14, 11 rows;
    # rows 11..22: window 2..25 (24), stages on 18, 15, 12; every stage on
    # 37 columns (13 x runs a row), window 43 columns
    want = 0
    for wrows, rows in ((23, (17, 14, 11)), (24, (18, 15, 12))):
        want += 6 * wrows * 43
        for s, nr in enumerate(rows):
            want += (nr * 13 + 37 * (nr // 3 + 1)) * 305
            want += nr * 37 * (14 if s == 0 else 17 if s == 1 else 11)
    assert fb2.ops_issued(23, 37, plan, viscous=False, variant="js",
                          adaptive=False) == want


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
