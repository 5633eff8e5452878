"""flops.py against hand counts at a tiny size."""

from benchmark import flops

CFG = {"d_model": 8, "n_heads": 2, "n_experts": 4, "d_ff": 16, "vocab": 10, "n_layers": 3,
       "window_blocks": 2, "block_size": 2}


def test_band_pairs_by_hand():
    # Blocks of 2, window of 2 blocks: query i sees keys from the start of
    # the previous block up to itself.
    # i: 0 -> {0}; 1 -> {0,1}; 2 -> {0..2}; 3 -> {0..3}; 4 -> {2..4}; 5 -> {2..5}
    assert [flops.band_pairs(i, i + 1, 2, 2) for i in range(6)] == [1, 2, 3, 4, 3, 4]
    assert flops.band_pairs(0, 6, 2, 2) == 17
    # A window covering every block is full causal attention.
    assert flops.band_pairs(0, 8, 4, 2) == 8 * 9 // 2


def test_attention_counts_band_pairs_and_bytes_once():
    f, b = flops.attention(CFG, 6)
    assert f == 4 * 8 * 17  # QK^T and PV, 2 flops a multiply-add, over d = H * dh
    assert b == 4 * 6 * 8 * 2  # q, k, v read and o written once, bf16


def test_moe_counts_one_expert_per_token():
    f, b = flops.moe(CFG, 5)
    assert f == 2 * 5 * 8 * 4 + 2 * 2 * 5 * 8 * 16
    assert b == 8 * 4 * 4 + 4 * 2 * 8 * 16 * 2 + 2 * 5 * 8 * 2
    _, b2 = flops.moe(CFG, 5, experts_read=2)
    assert b2 == 8 * 4 * 4 + 2 * 2 * 8 * 16 * 2 + 2 * 5 * 8 * 2


def test_forward_train_prefill_decode():
    t = 6
    per_layer = 8 * t * 64 + 4 * 8 * 17 + (2 * t * 8 * 4 + 4 * t * 8 * 16)
    assert flops.forward(CFG, t, 1) == 3 * per_layer + 2 * 8 * 10
    assert flops.prefill(CFG, t) == flops.forward(CFG, t, 1)
    assert flops.train_sequence(CFG, t) == 3 * (3 * per_layer + 2 * 5 * 8 * 10)
    # Decode at position 5 with a batch of 2: each token sees keys 2..5.
    step = 3 * (8 * 2 * 64 + 4 * 8 * 4 * 2 + (2 * 2 * 8 * 4 + 4 * 2 * 8 * 16)) + 2 * 2 * 8 * 10
    assert flops.decode_step(CFG, 2, 5) == step


def test_least_time_takes_the_larger_bound():
    assert flops.least_time(989e12, 0) == 1.0
    assert flops.least_time(0, 3.35e12) == 1.0
    assert flops.least_time(989e12, 2 * 3.35e12) == 2.0
