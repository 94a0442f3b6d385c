"""The work counts, tied to hand counts and to the figures PERF.md gives."""
import json
from pathlib import Path

import pytest

from portbench.harness.roofline import ITEMSIZE, bound_s
from portbench.work import avt_flops, flash_attention, packed_attention

PKG = Path(__file__).resolve().parents[1]


def _model(name):
    return json.loads((PKG / "configs" / f"{name}.json").read_text())["model"]


def test_feature_step_flops():
    # chip_smoke.py's count of expts/02's step at 64 x 256: 30.79 TFLOP
    assert 64 * avt_flops.train_clip_flops(_model("avt_h_tsn_ek100"), 256) / 1e12 == \
        pytest.approx(30.79, abs=0.005)


def test_vit_frame_flops_by_hand():
    # ViT-B/16 at 224: per block 197 tokens x (qkv 3C^2 + proj C^2 + MLP 8C^2)
    # x 2 FLOPs + QK^T and PV 4 x 197^2 x C; patches 196 x 768 x 768 x 2
    C, T = 768, 197
    block = 2 * T * 12 * C * C + 4 * T * T * C
    assert avt_flops.vit_frame_flops(_model("avt_b_h_ek100")) == 12 * block + 2 * 196 * 768 * C
    # bench.py's 35.2 GFLOP a frame
    assert avt_flops.vit_frame_flops(_model("avt_b_h_ek100")) / 1e9 == pytest.approx(35.2, rel=0.01)


def test_serve_counts_every_view():
    m = _model("avt_b_h_ek100")
    assert avt_flops.serve_clip_flops(m, 10, 6) == 6 * avt_flops.forward_clip_flops(m, 10)


def test_packed_bounds_at_n240():
    # PERF.md's kernel table: 0.0867 ms forward, 0.1518 ms backward, on bytes
    fwd = bound_s(*packed_attention.forward_work(240, 197, 12, 64, 2), "bfloat16")
    bwd = bound_s(*packed_attention.backward_work(240, 197, 12, 64, 2), "bfloat16")
    assert 1e3 * fwd == pytest.approx(0.0867, abs=1e-4)
    assert 1e3 * bwd == pytest.approx(0.1518, abs=1e-4)


def test_flash_forward_bound():
    # (64, 256, 4, 512) f32 causal: 0.160 ms on bytes against the TF32 peak
    nbytes, flops = flash_attention.forward_work(64, 256, 4, 512, ITEMSIZE["float32"], True)
    assert nbytes / 3.35e12 > flops / 495e12
    assert 1e3 * bound_s(nbytes, flops, "float32") == pytest.approx(0.1603, abs=1e-4)


def test_flash_pairs_by_hand():
    assert flash_attention.pairs(4, True) == 10 and flash_attention.pairs(4, False) == 16
    assert flash_attention.backward_work(1, 4, 1, 2, 4, True)[1] == 10 * 10 * 2


def test_readers_on_a_profile():
    """The roofline reader: the bound of a unit's launches over their device
    time, by the custom op's events, else by kernel names; nothing without
    a profile or without the op's path."""
    from portbench.harness import profile as profiling, readers
    from portbench.harness.cell import Run
    from portbench.tests._tiny import tiny_cell

    cell = tiny_cell("avt_b_h_ek100", "train_b24")
    cell.cfg["model"].update(img_size=224, patch_size=16, vit_width=768, vit_heads=12,
                             vit_depth=12)
    window = {"units": 10, "clips": 40, "seconds": 1.0}
    prof = profiling.Profile(2, 1.0, 0.5, [("short_attn_fwd_bf16<64>", 0.0, 1e3),
                                           ("bwd_query_bf16<64>", 2e3, 500.0)],
                             [], [], {"avt_tpu_torch::packed_short_attention": 0.004})
    N, T, H, D = 4 * 3, 197, 12, 64  # the tiny mix's frames a step, two steps profiled
    bound = 2 * 12 * (bound_s(*packed_attention.forward_work(N, T, H, D, 2), "bfloat16")
                  + bound_s(*packed_attention.backward_work(N, T, H, D, 2), "bfloat16"))
    took = 0.004 + 500e-6
    run = Run(cell, window, prof, unit_clips=[4, 4])
    assert readers.packed_roofline(run, backward=True) == pytest.approx(100 * bound / took)
    assert readers.packed_roofline(Run(cell, window, None), backward=True) is None
    assert readers.flash_roofline(run, backward=True) is None
    # busy 0.5 s over 8 clips against the window's 1 s over 40
    assert readers.idle_share(run) == pytest.approx(100 * (1 - (0.5 / 8) / (1.0 / 40)))
