"""The benchmark's FLOP and byte counts against hand-worked numbers."""

import math

from bench import harness, roofline


def test_bert_base_forward_at_128_tokens():
    cfg = harness.config("dr-bert-base")
    # per layer: qkv 2*128*768*2304, out 2*128*768*768,
    # attention 2*2*128*128*768, mlp 2*2*128*768*3072
    per_layer = 452_984_832 + 150_994_944 + 50_331_648 + 1_207_959_552
    assert roofline.encoder_flops(cfg, 128) == 12 * per_layer \
        == 22_347_251_712


def test_qwen2_0_5b_forward_at_128_tokens():
    cfg = harness.config("qwen2-0.5b-dr")
    # per layer: qkv 2*128*896*(896+2*128), out 2*128*896*896, causal
    # attention 2*2*(128*129/2)*896, swiglu 3*2*128*896*4864
    per_layer = 264_241_152 + 205_520_896 + 29_589_504 + 3_347_054_592
    assert roofline.encoder_flops(cfg, 128) == 24 * per_layer \
        == 92_313_747_456


def test_serve_call_q8_over_ms_marco():
    N, D = 8_841_823, 768
    assert roofline.score_flops(8, N, D) == 108_648_321_024
    assert roofline.search_bytes(8, N, D, 10) == \
        27_162_080_256 + 24_576 + 640
    b = roofline.search_bound_s(8, N, D, 10)
    assert b["by"] == "bytes"
    assert math.isclose(b["s"], 27_162_105_472 / 3.35e12)
    assert math.isclose(b["flops_s"], 108_648_321_024 / 67e12)


def test_encode_flops_sums_sequences():
    cfg = harness.config("dr-bert-base")
    assert roofline.encode_flops(cfg, [3, 5]) == \
        roofline.encoder_flops(cfg, 3) + roofline.encoder_flops(cfg, 5)
