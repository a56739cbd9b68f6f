"""The ``recformer-moonlight-16b-a3b.rank8k`` and ``recformer-base.finetune``
cells on the CPU at tiny sizes: the deepseek_v3 counts against a direct
count; the driver refusing a program without the backbone; the Moonlight
cell's driver end to end (in float32 the program reads rounding against
the reference; the control and the half-batch fault read apart; held
layer by layer, the control reads three times the bf16 program; a
routing, pooling or served-catalog fault reads apart); the
finetune driver's reference following the step's draws (in float32 every
reading is rounding). ``tiny.py``'s cells carry Longformer's sizes and
special ids, so the Moonlight cell has its own."""

import numpy as np
import pytest
import torch

from portbench import flops_deepseek_v3 as fd
from portbench import manifest, run
from portbench.tests.tiny import tiny_cell, tiny_traffic

BENCH = manifest.load_manifest()
CELL = "recformer-moonlight-16b-a3b.rank8k"
TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=24,
            max_position_embeddings=256, attention_window=(16,) * 3, max_token_num=256,
            max_item_embeddings=11, max_attr_num=3, max_attr_length=8, item_seq_len=32,
            pad_token_id=1022, bos_token_id=1020, eos_token_id=1021, sep_token_id=1021,
            mask_token_id=1023, initializer_range=0.2)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def moonlight_tiny(dtype="float32", seed=4321):
    cell = manifest.find_cell(BENCH, CELL, seed, "cpu")
    cell.config = cell.config.replace(**TINY, dtype=dtype, param_dtype=dtype)
    cell.traffic = tiny_traffic(cell.traffic)
    cell.limits = {}
    return cell


def test_counts_against_a_direct_count():
    from recformer_tpu_torch.models.heads import RecformerForSeqRec

    cfg = moonlight_tiny().config
    with torch.device("meta"):
        m = RecformerForSeqRec(cfg).longformer
    n = [1, 2, 5, 40]
    attn = m.layers[0].self_attn
    proj = sum(p.numel() for name, p in attn.named_parameters() if "layernorm" not in name)
    moe = m.layers[1].mlp
    per_expert = moe.experts.gate_up_proj[0].numel() + moe.experts.down_proj[0].numel()
    shared = sum(p.numel() for p in moe.shared_experts.parameters())
    dense = sum(p.numel() for p in m.layers[0].mlp.parameters())
    pairs = sum(1 for k in n for i in range(k) for j in range(k) if j <= i)
    H = cfg.num_attention_heads
    want = sum(n) * (3 * 2 * proj + 2 * dense
                     + 2 * 2 * (cfg.num_experts_per_tok * per_expert + shared
                                + moe.gate.weight.numel()))
    want += 3 * pairs * 2 * H * (cfg.qk_head_dim + cfg.v_head_dim)
    assert fd.encoder_forward(cfg, n) == want
    ops, nbytes = fd.moe_gemm_work(cfg, n)
    rows = sum(n) * cfg.num_experts_per_tok
    assert ops == 2.0 * rows * per_expert
    assert nbytes == 4.0 * (cfg.n_routed_experts * per_expert
                            + rows * (2 * cfg.hidden_size + 3 * cfg.moe_intermediate_size))
    assert fd.attn_work(cfg, [3]) == (2.0 * H * (cfg.qk_head_dim + cfg.v_head_dim) * 6,
                                      4.0 * H * (2 * cfg.qk_head_dim + 2 * cfg.v_head_dim) * 3)


def test_driver_refuses_a_program_without_the_backbone():
    cell = moonlight_tiny()
    cell.config = tiny_cell("recformer-base.rank").config
    with pytest.raises(SystemExit, match="deepseek_v3"):
        manifest.driver_module(cell.traffic["driver"]).Driver(cell)


def test_moonlight_cell_reads_rounding_and_its_control_and_fault_read_apart():
    out = run.run_cell(moonlight_tiny(), BENCH, 0.2, False)
    assert set(out["checks"]) == {"served_gap", "layer_gap", "layer_gap_mean"}
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4, (name, c)
    assert out["attempted"] >= 1 and 0 < out["valid_share"] <= 1
    d = out["driver"]
    for other in (d.control(), d.fault("half_batch")):
        assert max(other.values()) > 1e-2, other


def test_control_reads_three_times_the_bf16_program_layer_by_layer():
    """Held one layer at a time, the control (the reference in fp8 in the
    program's place) reads at least three times what the program in bf16
    reads, so a limit lies between them."""
    out = run.run_cell(moonlight_tiny("bfloat16"), BENCH, 0.2, False)
    program, control = out["readings"], out["driver"].control()
    for name in ("layer_gap", "layer_gap_mean"):
        assert control[name] >= 3 * program[name], (name, program[name], control[name])


@pytest.mark.parametrize("fault", ["routing", "pooling", "catalog"])
def test_a_program_fault_reads_apart(monkeypatch, fault):
    """A program whose router hands each token its neighbour experts, or
    that pools the first token, reads far above the control's layer gaps;
    one whose catalog served some items flipped reads apart on
    ``served_gap``."""
    from recformer_tpu_torch.models import deepseek_v3 as m
    from recformer_tpu_torch.training import loops

    cell = moonlight_tiny()
    names = ("layer_gap", "layer_gap_mean")
    if fault == "routing":
        route, E = m.route, cell.config.n_routed_experts
        monkeypatch.setattr(m, "route", lambda *a, **k: ((route(*a, **k)[0] + 1) % E,
                                                          route(*a, **k)[1]))
    elif fault == "pooling":
        monkeypatch.setattr(m, "last_token", lambda hidden, mask: hidden[:, 0])
    else:
        encode, names = loops.make_encode_items_step, ("served_gap",)

        def flipped(config, model):
            step = encode(config, model)

            def run_step(table, chunk):
                out = step(table, chunk).clone()
                out[5::8] = -out[5::8]
                return out

            return run_step

        monkeypatch.setattr(loops, "make_encode_items_step", flipped)
    readings = run.run_cell(cell, BENCH, 0.2, False)["readings"]
    for name in names:
        assert readings[name] > 0.3, (name, readings)


def test_finetune_reference_follows_the_step():
    cell = tiny_cell("recformer-base.finetune")
    cell.config = cell.config.replace(dtype="float32")
    cell.traffic["negatives"] = 20
    cell.limits = {}
    out = run.run_cell(cell, BENCH, 0.2, False)
    readings = out["readings"]
    assert set(readings) >= {"loss_gap", "grad_gap", "change_gap"}
    for name, v in readings.items():
        assert v < 1e-3, (name, v)
    assert out["attempted"] >= 1 and 0 < out["valid_share"] < 1
    half = out["driver"].fault("half_batch")
    assert half["grad_gap"] > 0.1, half
    assert np.isfinite(list(half.values())).all()
