"""The frozen cost arithmetic against shapes worked by hand."""
import pytest

from bench import costs

SC2 = {"hidden_size": 3072, "num_attention_heads": 24,
       "num_key_value_heads": 2, "intermediate_size": 12288,
       "vocab_size": 49152, "num_hidden_layers": 30, "act": "gelu",
       "sliding_window": 4096}
MIX = {"hidden_size": 4096, "num_attention_heads": 32,
       "num_key_value_heads": 8, "intermediate_size": 14336,
       "vocab_size": 32000, "num_hidden_layers": 8, "act": "swiglu",
       "num_local_experts": 8, "num_experts_per_tok": 2,
       "sliding_window": None}


def test_weight_bytes():
    # 4096 x 4096 at 4 bits: 8 MiB of codes and 4096*128 scale bytes
    assert costs.weight_bytes(4096, 4096, "mxint4") == 8388608 + 524288
    assert costs.weight_bytes(32, 1, "mxint8") == 33


def test_gemm_launch():
    fl, by = costs.gemm_launch(128, 3072, 12288, "mxint4")
    assert fl == 2 * 128 * 3072 * 12288
    assert by == 3072 * 12288 // 2 + 3072 * 12288 // 32 \
        + 128 * 3072 * 2 + 128 * 12288 * 4


def test_active_params():
    layer = 3072 * 3072 * 2 + 2 * 3072 * 256 + 2 * 3072 * 12288
    assert costs.active_params(SC2) == 30 * layer + 3072 * 49152
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    moe = 2 * 3 * 4096 * 14336 + 4096 * 8
    assert costs.active_params(MIX) == 8 * (attn + moe) + 4096 * 32000


def test_attention_pairs_and_window():
    # decode: one query at position 99 reads 100 keys; 24 heads of 128
    fl, by = costs.attn_launch(SC2, [(99, 1)])
    assert fl == 4 * 24 * 128 * 100
    assert by == 2 * 100 * 2 * 128 * 2 + 2 * 24 * 128 * 2
    # past the window a query reads 4096 keys
    fl, _ = costs.attn_launch(SC2, [(9999, 1)])
    assert fl == 4 * 24 * 128 * 4096
    # a chunk of 3 at cursor 0 reads 1 + 2 + 3 pairs
    fl, _ = costs.attn_launch(MIX, [(0, 3)])
    assert fl == 4 * 32 * 128 * 6


def test_stream_bytes_and_bound():
    b = costs.stream_bytes(SC2, "mxint8")
    per = sum(k * n * 33 / 32 for _, k, n, _ in costs.projections(SC2))
    assert b == pytest.approx(30 * per + 3072 * 49152 * 4)
    assert costs.bound_s(989e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_tick_executables():
    """A sequential chunk tick is a chunk alone (plain attention) then a
    decode step over every slot (paged); a mixed tick pads every slot's
    row to the chunk's width."""
    import numpy as np
    from bench.harness import work
    tick = {"decode": 1, "decode_pos": np.array([10, 20]),
            "chunk": (256, 100, 128)}
    seq = {"slots": 4, "cfg": MIX, "scheduler": "sequential"}
    cf = dict(MIX, capacity_factor=4.0)
    seq["cfg"] = cf
    assert work.executables(seq, tick) == [
        (128, 128, [], [(256, 100)]), (4, 4, [(10, 1), (20, 1)], [])]
    mixed = dict(seq, scheduler="mixed")
    assert work.executables(mixed, tick) == [
        (512, 512, [(10, 1), (20, 1), (256, 100)], [])]
    w = work.tick_work(dict(seq, fmt="mxint8"), tick)
    assert w["model"][0] > 2 * costs.active_params(cf) * 102
