"""The Moonlight-16B-A3B cell (configs/moonlight_h_tsn_ek100.json, family and
reference avt_mla_moe) on the CPU at tiny sizes (the widths cut, which no
benchmark cell may do): the port agrees with the plain reference, the
control reads above it, each fault turns `correct` false; the
configuration against the catalog's, its work counts and its readers."""
import copy
import json
import math
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.harness import cell as cells, faults
from portbench.harness.profile import Profile
from portbench.harness.roofline import bound_s
from portbench.work import flash_attention, mla_attention, mla_moe_flops

PKG = Path(__file__).resolve().parents[1]
NAME = "moonlight_h_tsn_ek100.train_t256"
SEED = 2 ** 31 + 101
TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, intermediate_size=48,
            moe_intermediate_size=16, n_router_experts=8, n_routed_experts=4, expert_rank=1,
            num_experts_per_tok=3)


def _cfg():
    return json.loads((PKG / "configs" / "moonlight_h_tsn_ek100.json").read_text())


def _tiny(dtype="bfloat16"):
    cell = cells.load_cell(NAME)
    cfg = copy.deepcopy(cell.cfg)
    cfg.update(TINY)
    cfg["model"].update(backbone_dim=16, num_actions=11, compute_dtype=dtype)
    cfg["input"]["feature_dim"] = 16
    cfg["reference"]["block_clips"] = 2
    tr = dict(cell.traffic, clips=4, length=3, pool=4, profile_units=2)
    return cells.attach(cells.Cell(NAME, cfg, tr, cell.limits, cell.end_to_end,
                                   cell.per_layer))


def _numbers(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 6e-2)])
def test_port_agrees_with_reference(dtype, tol):
    r = cells.run(_tiny(dtype), SEED, 0.05, False, "cpu")
    got = _numbers(r)
    assert [n for n in r["notes"] if not n.startswith(("set-up s:", "window:"))] == []
    assert all(v <= tol for v in got.values()), got
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_control_reads_above_the_program():
    cell = _tiny()
    program = _numbers(cells.run(cell, SEED, 0.05, False, "cpu"))
    control = calibrate.control_numbers(cell, SEED, "cpu")
    assert any(control[k] > 1.5 * program[k] for k in control), (control, program)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_fault_is_not_correct(fault):
    r = cells.run(_tiny(), SEED, 0.05, False, "cpu", tamper=faults.FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_configuration_against_the_catalog():
    """Every number of the catalog's Moonlight-16B-A3B config is the file's,
    but the two cuts `reduced` names; the published counts stand beside them."""
    cfg = _cfg()
    catalog = {"first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 11264,
               "kv_lora_rank": 512, "moe_intermediate_size": 1408, "n_group": 1,
               "n_routed_experts": 64, "n_shared_experts": 2, "num_attention_heads": 16,
               "num_experts_per_tok": 6, "num_hidden_layers": 27, "qk_nope_head_dim": 128,
               "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_theta": 50000,
               "routed_scaling_factor": 2.446, "topk_group": 1, "v_head_dim": 128}
    changed = {k for k, v in catalog.items() if cfg[k] != v}
    assert changed == set(cfg["reduced"]) == {"num_hidden_layers", "n_routed_experts"}
    assert cfg["published"] == {k: catalog[k] for k in changed}
    assert cfg["n_router_experts"] == 64 and cfg["expert_shards"] * 8 == 64
    assert cfg["model"]["compute_dtype"] == "bfloat16"


def test_parameters_and_flops_at_full_size():
    """1.30 B parameters (the issue's count: 83.0 M dense layer, 100.4 M a
    MoE layer, AVT's ~8 M); 54.2 TFLOP a step of 64 x 256 features."""
    from portbench.reference import avt_mla_moe as ref

    cfg = _cfg()
    specs = ref.param_specs(cfg)
    sizes = {name: math.prod(shape) for name, shape, *_ in specs}
    assert len(sizes) == len(specs)
    total = sum(v for k, v in sizes.items() if not ref.is_buffer(k))
    assert total / 1e9 == pytest.approx(1.30, abs=0.005)
    layer1 = sum(v for k, v in sizes.items() if ".layers.1." in k and not ref.is_buffer(k))
    assert layer1 / 1e6 == pytest.approx(100.4, abs=0.1)
    assert 64 * mla_moe_flops.train_clip_flops(cfg, 256) / 1e12 == pytest.approx(54.25, abs=0.01)


def test_mla_work_at_equal_widths_is_the_flash_count():
    for causal in (True, False):
        for work, same in ((mla_attention.forward_work, flash_attention.forward_work),
                           (mla_attention.backward_work, flash_attention.backward_work)):
            assert work(2, 130, 3, 64, 64, 2, causal) == same(2, 130, 3, 64, 2, causal)
    assert mla_attention.forward_work(1, 4, 1, 3, 2, 4, True)[1] == 2 * 10 * 5
    assert mla_attention.backward_work(1, 4, 1, 3, 2, 4, True)[1] == 2 * 10 * (6 + 2 + 3 + 2)


def test_readers_on_a_profile():
    """The roofline of the flash launches at (192, 128) over their device
    time; the expert load from the counters; nothing without a profile."""
    cell = cells.load_cell(NAME)
    window = {"units": 10, "clips": 640, "seconds": 1.0}
    prof = Profile(2, 1.0, 0.5, [], [], [], {"avt_tpu_torch::flash_attention": 0.01,
                                             "avt_tpu_torch::flash_attention_bwd": 0.03})
    run = cells.Run(cell, window, prof, unit_clips=[64, 64])
    fwd = bound_s(*mla_attention.forward_work(64, 256, 16, 192, 128, 2, True), "bfloat16")
    bwd = bound_s(*mla_attention.backward_work(64, 256, 16, 192, 128, 2, True), "bfloat16")
    roofline = cells.reader("mla_attn_roofline.train")
    assert roofline(run) == pytest.approx(100 * 2 * 13 * (fwd + bwd) / 0.04)
    assert roofline(cells.Run(cell, window, None)) is None
    load = cells.reader("expert_load.train")
    cell.family = type("F", (), {"counters": staticmethod(
        lambda: {"avt.moe.pairs_held": 1000.0, "avt.moe.pairs_max": 250.0})})
    assert load(run) == pytest.approx(250 / (1000 / 8))
    cell.family = type("F", (), {"counters": staticmethod(dict)})
    assert load(run) is None


@pytest.mark.cuda
def test_cell_on_the_card():
    """A whole run of the cell on the card with a short window."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels on the card")
    r = cells.run(cells.load_cell(NAME), SEED, 2.0, False, "cuda")
    assert r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    """The fp8 control at the cell's own size, judged under its limits."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    cell = cells.load_cell(NAME)
    ok, checks = calibrate.judged(cell, calibrate.control_numbers(cell, SEED, "cuda"))
    assert not ok, checks
