"""The FLOP and byte arithmetic against shapes worked out by hand for
internlm2-1.8b (D 2048, 16 heads of 128, 8 KV heads, F 8192, 24 layers,
vocabulary padded to 92672)."""
import json

import pytest

from cardbench import cost, manifest, readers, weights

CFG = json.loads((manifest.HERE / "configs" / "internlm2-1.8b.json")
                 .read_text())


def test_packed_bytes():
    # 2048 x 8192: codes 8,388,608 bytes, 262,144 codebooks of 32 bytes
    assert cost.packed_bytes(2048, 8192) == 8388608 + 262144 * 32


def test_dense_matmul_one_row():
    per_layer_w = 2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 8192
    fl, by = cost.dense_matmul(CFG, 1)
    assert fl == 24 * 2 * per_layer_w
    # codes half a byte a weight, 32 bytes of codebook a 64 weights, and
    # each projection's bf16 row in and out: q, k, v, o, gate, up, down
    rows = (2048 + 2048) + 2 * (2048 + 1024) + (2048 + 2048) \
        + 3 * (2048 + 8192)
    assert by == 24 * (per_layer_w // 2 + per_layer_w // 64 * 32 + 2 * rows)


def test_unembed_and_vocab():
    assert weights.vocab_padded(CFG) == 92672
    fl, by = cost.unembed(CFG, 8, 92672)
    assert fl == 2 * 8 * 2048 * 92672
    assert by == 2048 * 92672 // 2 + 2048 * 92672 // 64 * 32 \
        + 8 * (2048 + 92672) * 4


def test_paged_attention_contexts():
    fl, by = cost.paged_attention(CFG, [10, 20])
    assert fl == 24 * 4 * 30 * 16 * 128
    assert by == 24 * (30 * 2 * 8 * 128 * 2 + 2 * 2 * 16 * 128 * 2)


def test_least_seconds_takes_the_larger_bound():
    assert cost.least_seconds(cost.PEAK_FLOPS, 0) == pytest.approx(1.0)
    assert cost.least_seconds(0, cost.HBM_BYTES_S * 2) == pytest.approx(2.0)


def test_paged_attention_prefill_reads_each_segment_once():
    # two segments: positions 0..3 of one sequence, 10..11 of another
    fl, by = cost.paged_attention_prefill(CFG, [(0, 4), (10, 12)])
    pairs = (1 + 2 + 3 + 4) + (11 + 12)
    assert fl == 24 * 4 * pairs * 16 * 128
    # K and V of 4 + 12 keys, q and output of 6 positions
    assert by == 24 * (16 * 2 * 8 * 128 * 2 + 6 * 2 * 16 * 128 * 2)
    # a decode row at context 12 reads the same keys as the segment's end
    assert cost.paged_attention(CFG, [12])[1] < by


def test_experts():
    g = json.loads((manifest.HERE / "configs" / "granite-moe-3b-a800m.json")
                   .read_text())
    fl, by = cost.experts(g, 64)
    assert fl == 32 * 2 * 64 * 8 * 3 * 1536 * 512
    w = 3 * (1536 * 512 // 2 + 1536 * 512 // 64 * 32)
    touched = 40 * (1 - 0.8 ** 64)
    assert by == pytest.approx(32 * (touched * w + 64 * 8 * 2 * 2048 * 2))
    assert 39.99 < touched < 40


def test_model_flops_and_launches():
    rec = dict(kind="serve", steps=[
        dict(kind="decode_horizon", rows=[(100, 103), (50, 51)],
             traced=True, dt=0.1),
        dict(kind="prefill_packed", rows=[(0, 4)], traced=True, dt=0.1),
        dict(kind="decode_horizon", rows=[(7, 9)], traced=False, dt=0.1)])
    got = readers.launches(rec)
    assert got == [([101, 51], 2, []), ([102], 1, []), ([103], 1, []),
                   ([1, 2, 3, 4], 1, [(0, 4)])]
    assert readers.launches(rec, "prefill") == got[3:]
    assert readers.launches(rec, "decode") == got[:3]
    per = 2 * (2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 8192)
    want = 24 * (per * 2 + 4 * 152 * 16 * 128) + 2 * 2 * 2048 * 92672
    assert cost.model_flops(CFG, [101, 51], 2, 92672) == want
