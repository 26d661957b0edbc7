"""The host-side tile and split plans of the port's attention kernels
(``kernels/attn_density.py::plan``, ``kernels/decode_mqattn.py::plan``):
pure arithmetic, so they are checked here on the CPU.  The CUDA sources
compute the same rule (``attn_density_rows``, ``split_plan``); the
``cuda``-marked tests in ``tests/test_torch_cuda.py`` hold the two
against each other on the card.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import attn_density as kad  # noqa: E402
from repro_torch.kernels import decode_mqattn as kmq  # noqa: E402

SMS = 132                                   # an H100 SXM


def test_attn_density_plan_fills_the_card_at_serving_extend():
    """Serving's extend of llama2-7b (64 bucketed queries, H = KV = 32)
    runs 16-row tiles: 4 tiles x 32 kv-heads = 128 blocks, not 32."""
    rows, n_tiles, blocks = kad.plan(1, 64, 32, 32)
    assert (rows, n_tiles, blocks) == (16, 4, 128)
    assert blocks >= 128


@pytest.mark.parametrize("B,Sq,H,KV,rows", [
    (1, 512, 32, 32, 64),       # the long append: 256 blocks of 64 rows
    (1, 2048, 32, 32, 64),      # the Pallas kernel's setting
    (1, 64, 32, 4, 16),         # G 8: 32 tiles of 16 rows x 4 kv-heads
    (1, 24, 64, 1, 16),         # G 64: one query's heads over 4 tiles
    (2, 37, 4, 4, 16),          # rows off the tile
    (4, 64, 32, 32, 16),        # batch 4: 128 wide blocks are too few
])
def test_attn_density_plan_rows_and_scratch(B, Sq, H, KV, rows):
    """64-row tiles exactly where they still give every SM a block; the
    tiles cover the Sq G rows with less than one tile to spare, which
    sizes the (B, KV, n_tiles, Sk) scratch."""
    r, n_tiles, blocks = kad.plan(B, Sq, H, KV)
    G = H // KV
    wide = B * KV * -(-Sq * G // 64)
    assert r == (64 if wide >= SMS else 16)
    assert (r, blocks) == (rows, B * KV * n_tiles)
    assert (n_tiles - 1) * r < Sq * G <= n_tiles * r


def test_decode_mqattn_plan_fills_the_card_at_serving_decode():
    """llama2-7b's quant-resident decode at batch 1 over 512 positions:
    8 splits of 64 keys, 256 blocks (two per SM), not 32; over 4096
    positions 16 splits of 256 keys, 512 blocks."""
    n, length, blocks = kmq.plan(1, 512, 32)
    assert (n, length, blocks) == (8, 64, 256)
    assert blocks >= SMS
    assert kmq.plan(1, 4096, 32) == (16, 256, 512)


@pytest.mark.parametrize("B,S,KV", [
    (1, 4096, 32), (4, 512, 32), (2, 4096, 8), (3, 4100, 4), (1, 16, 2),
    (4, 4096, 32), (1, 65536, 32), (2, 300, 2), (8, 64, 32),
])
def test_decode_mqattn_plan_splits_and_scratch(B, S, KV):
    """The splits cover S with less than one split to spare, hold 64 to
    1024 keys (fewer only when S itself is shorter than 64), give the
    grid two to four blocks per SM wherever 64-key splits allow it, and
    the scratch holds the scores, each split's (m, l) and PV partial."""
    n, length, blocks = kmq.plan(B, S, KV)
    assert (n - 1) * length < S <= n * length
    assert length <= kmq.MAX_SPLIT_KEYS
    assert length >= min(S, kmq.MIN_SPLIT_KEYS) or n == 1
    assert blocks == n * KV * B
    if S >= 64 * -(-2 * SMS // (B * KV)):
        cap = B * KV * -(-S // kmq.MAX_SPLIT_KEYS)   # 1024 keys a split
        assert 2 * SMS <= blocks <= max(4 * SMS, B * KV, cap)
    H, hd = 4 * KV, 128
    assert kmq.scratch_floats(B, S, H, KV, hd) == B * H * (S + n * (2 + hd))


@pytest.mark.parametrize("B,S,KV,expect", [
    (1, 512, 32, (8, 64, 256)),      # the smoke's int8 decode, serving
    (4, 4096, 32, (4, 1024, 512)),   # the timed fused + mass shape
    (3, 4100, 4, (44, 94, 528)),     # a ragged tail
    (1, 16, 2, (1, 16, 2)),          # one split
    (2, 300, 2, (4, 75, 16)),        # hd 20 in the edge cases
])
def test_decode_qattn_plan_and_scratch(B, S, KV, expect):
    """The all-int8 cache runs decode_mqattn's split kernels with the
    same plan and the same scratch layout: scores (B, H, S), then each
    split's (m, l) and PV partial."""
    from repro_torch.kernels import decode_qattn as kdq
    assert kdq.plan(B, S, KV) == kmq.plan(B, S, KV) == expect
    n, length, _ = expect
    assert (n - 1) * length < S <= n * length
    H, hd = 4 * KV, 20 if S == 300 else 128
    assert kdq.scratch_floats(B, S, H, KV, hd) == \
        B * H * (S + n * (2 + hd))
