"""The yardstick's flop and byte counts against hand-worked values at the
benchmark's configurations."""

import json
from pathlib import Path

import pytest

from bench.cost import causal_pairs, flash, matmul
from bench.cost import model as W
from bench.spec import model_spec

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def spec(name):
    return model_spec(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_matmul_counts_each_operand_once():
    w = matmul(8, 16, 32, "bfloat16")
    assert w.flops == 2 * 8 * 16 * 32
    assert w.bytes == 2 * (8 * 16 + 16 * 32 + 8 * 32)
    experts = matmul(8, 16, 32, "bfloat16", n_weights=4)
    assert experts.bytes == 2 * (8 * 16 + 4 * 16 * 32 + 8 * 32)
    # the bound is the larger of compute and memory time
    assert w.bound_s == max(w.flops / 989e12, w.bytes / 3.35e12)


@pytest.mark.parametrize("sq,skv,off,pairs", [
    (4, 4, None, 10), (1, 5, None, 5), (3, 3, 0, 6), (2, 8, 6, 15),
    (4096, 4096, None, 4096 * 4097 // 2)])
def test_causal_pairs(sq, skv, off, pairs):
    assert causal_pairs(sq, skv, off) == pairs


def test_flash_counts():
    f = flash(2, 4, 3, 1, 8, "float32")
    pairs = 2 * 3 * 10
    assert f.flops == 4 * 8 * pairs
    assert f.bytes == 4 * (2 * 2 * 4 * 3 * 8 + 2 * 2 * 4 * 1 * 8)
    b = flash(2, 4, 3, 1, 8, "float32", backward=True)
    assert b.flops == 10 * 8 * pairs


def test_phi_layer_and_step_by_hand():
    s = spec("phi3.5-moe-1L")
    T = 2 * 4096
    attn = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096      # 41.9M
    experts = 2 * 3 * 4096 * 6400                            # top-2
    router = 4096 * 16
    assert W.active_layer_params(s) == attn + router + experts
    assert W.layer_forward(s, T).flops == 2 * T * (attn + router + experts)
    # 6 x (one layer + the untied head) x tokens, plus attention x 3
    head = 4096 * 32064
    att = 4 * 128 * 32 * 2 * causal_pairs(4096, 4096)
    assert W.train_model_flops(s, 2, 4096) == \
        6 * (attn + router + experts + head) * T + 3 * att
    assert W.train_model_flops(s, 2, 4096) == pytest.approx(1.7059e13,
                                                          rel=1e-3)
    # the head runs in f32 at 67 TFLOP/s: 6 x T x D x V flops bound it
    mm = W.train_matmul(s, 2, 4096, 1)
    assert mm.flops == 3 * 2 * T * (attn + router + experts + head)
    assert mm.bound_s > 6 * T * head / 67e12


def test_smollm_step_by_hand():
    s = spec("smollm-135m")
    per_layer = 2 * 576 * 576 + 2 * 576 * 192 + 3 * 576 * 1536
    assert per_layer == 3_538_944
    assert W.active_layer_params(s) == per_layer
    tokens = 32 * 2048
    att = 30 * 4 * 64 * 9 * causal_pairs(2048, 2048)
    assert W.train_model_flops(s, 32, 2048) == \
        6 * (30 * per_layer + 576 * 49152) * tokens + 3 * 32 * att
    assert W.train_model_flops(s, 32, 2048) == pytest.approx(6.680e13,
                                                           rel=1e-3)
    # two microbatches of 16 x 2048: the flash work is twice one's
    one = W.train_flash(s, 16, 2048, 1)
    assert W.train_flash(s, 32, 2048, 2).flops == 2 * one.flops


def test_serving_counts_by_hand():
    s = spec("phi3.5-moe-8L")
    n = 2000
    assert W.prefill_model_flops(s, n) == (
        2 * (8 * W.active_layer_params(s) * n + 4096 * 32064)
        + 8 * 4 * 128 * 32 * causal_pairs(n, n))
    # a decode token at position t sees t + 1 keys
    one = W.decode_model_flops(s, [99])
    assert one == 2 * (8 * W.active_layer_params(s) + 4096 * 32064) \
        + 8 * 4 * 128 * 32 * 100
    # a decode step reads every expert's weights once, in each of 8 layers
    d = W.decode_matmul(s, 128)
    assert d.bytes > 2 * 8 * 3 * 16 * 4096 * 6400
