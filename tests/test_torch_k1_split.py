"""The f64 kernel's split over k (``ops/normal_eq.py``), on the host: the
split chooser at the H100's 132 SMs for every shape the port's paths give
K1, its column floor, the workspace's size, and the plain version of the
split's sum kernel. The kernels themselves are held against their plain
versions in tests/test_torch_gpu.py and chip_smoke.py, on the card."""

import importlib

import numpy as np
import pytest
import torch

ne = importlib.import_module("distributedlpsolver_tpu_torch.ops.normal_eq")

H100_SMS = 132

# (m, n, lanes) of each launch a path of the port gives K1 in f64, and the
# split the chooser must give it: 1 wherever the triangle's tiles fill the
# card or the reduction is short, so the launch keeps its bits.
UNSPLIT = {
    "main path 2048x10240": (2048, 10240, 1),
    "reference 10000x50000": (10000, 50000, 1),
    "two-phase auto PCG f64 finish 4096x20480": (4096, 20480, 1),
    "batched 1024x128x512": (128, 512, 1024),
    "serve bucket 256x128x512": (128, 512, 256),
    "slice lanes 128x128x512": (128, 512, 128),
    "sharded gloo2 2048x5120": (2048, 5120, 1),
    "sharded gloo4 2048x2560": (2048, 2560, 1),
    "pds-10 K lanes 32x432x1263": (432, 1263, 32),
    "pds-20 K lanes 64x432x1265": (432, 1265, 64),
    "pds-10 rank lanes 16x432x1263": (432, 1263, 16),
    "pds-10 rank lanes 8x432x1263": (432, 1263, 8),
    "pds-10 rank lanes after shrink 11x432x1263": (432, 1263, 11),
    "scenario main 1024x24x36": (24, 36, 1024),
    "scenario rank 512x24x36": (24, 36, 512),
    "scenario stormG2 8x528x1259": (528, 1259, 8),
    "scenario full bucket 1024x528x1259": (528, 1259, 1024),
}
# The block tier's linking rows: 91 or 325 triangle tiles against 264
# block slots, each a reduction over 15,935-92,813 columns.
SPLIT = {
    "pds-10 link 800x46247": ((800, 46247, 1), 11),
    "pds-20 link 1600x92813": ((1600, 92813, 1), 4),
    "pds-10 rank 0 of 2 link 800x26039": ((800, 26039, 1), 8),
    "pds-10 rank 0 of 4 link 800x15935": ((800, 15935, 1), 5),
    "pds-10 rank 0 after shrink link 800x19724": ((800, 19724, 1), 8),
}


@pytest.mark.parametrize(
    "name,shape,expect",
    [(k, v, 1) for k, v in UNSPLIT.items()] + [(k, v, s) for k, (v, s) in SPLIT.items()],
)
def test_split_chooser_on_the_paths_shapes(name, shape, expect):
    m, n, lanes = shape
    assert ne.split_count(m, n, lanes, H100_SMS) == expect


def test_split_chooser_takes_the_fewest_waves_a_column():
    """The chosen split's cost, waves over splits, is within the slack of
    the least over every allowed split, and no smaller split is."""
    m, n, lanes = 800, 46247, 1
    blocks, slots = 13 * 14 // 2, H100_SMS * ne.F64_BLOCKS_PER_SM
    cost = {s: -(-blocks * s // slots) / s for s in range(1, n // ne.SPLIT_MIN_COLUMNS + 1)}
    s = ne.split_count(m, n, lanes, H100_SMS)
    assert cost[s] <= min(cost.values()) * ne.SPLIT_SLACK
    assert all(cost[t] > min(cost.values()) * ne.SPLIT_SLACK for t in range(1, s))


@pytest.mark.parametrize("n", [0, 1, 2047, 4095])
def test_split_chooser_never_splits_under_the_column_floor(n):
    """A reduction shorter than two splits' floor is never split, however
    few the tiles: one tile of one lane on a card of 132 SMs."""
    assert ne.split_count(64, n, 1, H100_SMS) == 1


def test_split_chooser_gives_each_split_the_floor_at_least():
    for n in range(2048, 60000, 997):
        s = ne.split_count(64, n, 1, H100_SMS)
        assert s >= 1 and n // s >= ne.SPLIT_MIN_COLUMNS


@pytest.mark.parametrize(
    "m,lanes,splits,numel",
    [
        (800, 1, 11, 1 * 11 * 91 * 64 * 64),
        (1600, 1, 4, 1 * 4 * 325 * 64 * 64),
        (129, 3, 7, 3 * 7 * 6 * 64 * 64),
        (2048, 1, 1, 0),  # no split, no workspace
    ],
)
def test_workspace_holds_a_partial_tile_a_lane_split_and_tile(m, lanes, splits, numel):
    assert ne.workspace_numel(m, lanes, splits) == numel


def test_pds10_link_workspace_is_a_few_tens_of_megabytes():
    s = ne.split_count(800, 46247, 1, H100_SMS)
    assert ne.workspace_numel(800, 1, s) * 8 == 11 * 91 * 64 * 64 * 8 == 32_800_768


@pytest.mark.parametrize("tiles", [1, 7, 8, 9, 13, 25])
def test_tile_index_walks_the_lower_triangle_once(tiles):
    bi, bj = ne._tile_index(tiles)
    pairs = set(zip(bi.tolist(), bj.tolist()))
    assert len(bi) == len(pairs) == tiles * (tiles + 1) // 2
    assert all(j <= i < tiles for i, j in pairs)


def test_tile_index_follows_the_kernels_block_order():
    """Groups of 8 block rows; inside a group, column by column, top to
    bottom (normal_eq.cu::tile_of_block)."""
    bi, bj = ne._tile_index(10)
    assert list(zip(bi.tolist(), bj.tolist()))[:3] == [(0, 0), (1, 0), (2, 0)]
    # The second group (rows 8-9) starts with its full-height columns.
    start = 8 * 9 // 2
    assert list(zip(bi.tolist(), bj.tolist()))[start:start + 4] == [(8, 0), (9, 0), (8, 1), (9, 1)]


@pytest.mark.parametrize("m,lanes,splits", [(200, 2, 3), (64, 1, 2), (129, 1, 7)])
def test_split_sum_plain_version_adds_the_partials_in_place(m, lanes, splits):
    """The plain version of the sum kernel: each lower-triangle tile of M
    is the sum of its partials, in split order, mirrored above the
    diagonal; against a direct placement in numpy."""
    rng = np.random.default_rng(m + splits)
    work = torch.from_numpy(rng.standard_normal(ne.workspace_numel(m, lanes, splits)))
    M = ne.split_sum_reference(work, m, lanes, splits)
    tiles = -(-m // 64)
    P = work.numpy().reshape(lanes, splits, tiles * (tiles + 1) // 2, 64, 64)
    bi, bj = ne._tile_index(tiles)
    full = np.zeros((lanes, tiles * 64, tiles * 64))
    for t, (i, j) in enumerate(zip(bi.tolist(), bj.tolist())):
        acc = P[:, 0, t].copy()
        for s in range(1, splits):
            acc = acc + P[:, s, t]
        full[:, i * 64:(i + 1) * 64, j * 64:(j + 1) * 64] = acc
    low = np.tril(full[:, :m, :m])
    expect = low + np.swapaxes(np.tril(low, -1), 1, 2)
    assert M.shape == (lanes, m, m)
    assert np.array_equal(M.numpy(), expect)


@pytest.mark.parametrize("dtype,splits", [(torch.float32, 2), (torch.bfloat16, 2), (torch.float64, 0)])
def test_split_is_refused_off_f64_and_below_one(dtype, splits):
    """Only an f64 launch splits, and at least once: anything else is
    refused before the device is looked at."""
    A, d = torch.zeros(4, 6, dtype=dtype), torch.zeros(6, dtype=dtype)
    out = torch.float32 if dtype == torch.bfloat16 else dtype
    with pytest.raises(ValueError, match="splits"):
        ne._launch(A, d, out, splits=splits)
