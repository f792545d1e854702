"""The flash kernels' launch order (``flash_attention.launch_order``) on the
CPU: every visited 64 x 64 tile is computed exactly once, the totals match
the roofline's tile counts, the forward and dK/dV hand the card their
longest chains first across all heads, dQ keeps its tile-major order, and
the roofline's schedule model reads the same order."""

import importlib
import math

import pytest

from bluefog_tpu_torch.benchmarks import attention_roofline as roof

fa = importlib.import_module("bluefog_tpu_torch.kernels.flash_attention")

CASES = [  # (tq, tk, q_start, k_start, causal)
    (2048, 2048, 0, 0, True), (1000, 1000, 0, 0, True), (200, 200, 96, 0, True),
    (256, 256, 0, 40, True), (130, 130, 7, 3, True), (256, 256, 0, 512, True),
    (192, 192, 512, 0, True), (40, 40, 0, 0, True), (320, 192, 128, 0, True),
    (192, 448, 0, 0, False), (320, 320, 0, 0, False)]


def _visible_tiles(tq, tk, q_start, k_start, causal):
    """The 64 x 64 tiles holding a visible (query, key) pair, pair by pair."""
    tiles = set()
    for qi in range(-(-tq // 64)):
        for kj in range(-(-tk // 64)):
            rows = range(qi * 64, min(qi * 64 + 64, tq))
            cols = range(kj * 64, min(kj * 64 + 64, tk))
            if not causal or any(k_start + c <= q_start + r for r in rows for c in cols):
                tiles.add((qi, kj))
    return tiles


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("tq,tk,q_start,k_start,causal", CASES)
def test_every_visible_tile_is_computed_once(kernel, tq, tk, q_start, k_start, causal):
    bh = 3
    blocks, rows = fa.launch_order(kernel, tq, tk, q_start, k_start, causal, bh=bh)
    assert rows == (64 if kernel == "dq" else 128)
    n_rows = tk if kernel == "dkv" else tq
    assert len(blocks) == bh * -(-n_rows // rows)
    want = _visible_tiles(tq, tk, q_start, k_start, causal)
    for h in range(bh):
        got = [pair for head, tiles in blocks if head == h for pair in tiles]
        assert len(got) == len(set(got)) and set(got) == want


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("T,q_start,k_start", [
    (2048, 0, 0), (1000, 0, 0), (200, 96, 0), (256, 0, 40), (130, 7, 3), (256, 0, 512)])
def test_totals_match_the_roofline_tile_counts(kernel, T, q_start, k_start):
    blocks, _ = fa.launch_order(kernel, T, T, q_start, k_start, True, bh=2)
    assert sum(len(tiles) for _, tiles in blocks) == 2 * sum(
        roof.tile_counts(T, 64, q_start, k_start))


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
@pytest.mark.parametrize("tq,tk,q_start,k_start,causal", CASES)
def test_longest_chains_launch_first_across_heads(kernel, tq, tk, q_start, k_start, causal):
    """Chain length is the steps a block takes in sequence: the key tiles a
    forward block walks, the query tiles a dK/dV block walks (its two
    slabs take each step side by side)."""
    blocks, _ = fa.launch_order(kernel, tq, tk, q_start, k_start, causal, bh=4)
    walked = 1 if kernel == "fwd" else 0
    lengths = [len({pair[walked] for pair in tiles}) for _, tiles in blocks]
    assert lengths == sorted(lengths, reverse=True)
    # heads fastest: the first blocks are the same tile of every head
    assert [head for head, _ in blocks[:4]] == [0, 1, 2, 3]


@pytest.mark.parametrize("tq,tk,q_start,k_start,causal", CASES)
def test_dq_order_is_unchanged(tq, tk, q_start, k_start, causal):
    """One block a 64-row query tile, tiles fastest and heads slowest, each
    walking the key tiles from 0 up to the causal break."""
    blocks, _ = fa.launch_order("dq", tq, tk, q_start, k_start, causal, bh=2)
    n_q, n_k = -(-tq // 64), -(-tk // 64)
    assert [(h, tiles[0][0] if tiles else None) for h, tiles in blocks][:1] in (
        [(0, 0)], [(0, None)])
    i = 0
    for h in range(2):
        for qi in range(n_q):
            head, tiles = blocks[i]
            i += 1
            q_last = q_start + min(qi * 64 + 64, tq) - 1
            want = [kj for kj in range(n_k) if not causal or k_start + kj * 64 <= q_last]
            assert head == h and tiles == [(qi, kj) for kj in want]


def test_forward_walks_each_slab_up_to_the_diagonal_in_key_order():
    blocks, _ = fa.launch_order("fwd", 2048, 2048, bh=1)
    head, tiles = blocks[0]  # the last 128 rows: slabs 30 and 31
    assert head == 0 and tiles[:4] == [(30, 0), (31, 0), (30, 1), (31, 1)]
    assert len(tiles) == 63 and tiles[-1] == (31, 31)


def test_unknown_kernel_is_refused():
    with pytest.raises(ValueError, match="unknown kernel"):
        fa.launch_order("dqkv", 64, 64)


def test_the_schedule_model_reads_the_launch_order():
    """sched over the real blocks: at the path shape the forward's 384
    blocks of 128 rows, longest (63 tiles) first."""
    blocks, _ = fa.launch_order("fwd", 2048, 2048, bh=24)
    per_block = [len(tiles) for _, tiles in blocks]
    assert len(per_block) == 384 and per_block[0] == 63 and sum(per_block) == 12672
    # longest first on 132 slots ends no later than the same blocks shortest first
    tile_s = 1e-9
    first = roof.scheduled_ms(per_block, 132, tile_s)
    last = roof.scheduled_ms(per_block[::-1], 132, tile_s)
    assert first <= last
    assert first >= max(per_block) * tile_s * 132 * 1e3 - 1e-12
    assert math.isclose(roof.scheduled_ms(per_block, 1, tile_s), sum(per_block) * tile_s * 1e3)


@pytest.mark.parametrize("err,match", [
    (-2, "no cuTensorMapEncodeTiled"), (10001, r"encode failed \(CUresult 1\)"),
    (700, "launch failed with error 700")])
def test_launch_errors_name_their_cause(err, match):
    """A refused tensor-map encode or launch raises, naming which it was."""
    fa._raise_on("flash_fwd", 0)
    with pytest.raises(RuntimeError, match=match):
        fa._raise_on("flash_fwd", err)
