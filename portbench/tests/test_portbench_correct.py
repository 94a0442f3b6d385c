"""The comparison that decides `correct`, driven through a whole run on the
CPU at tiny sizes (the look for a card skipped): the port agrees with the
plain reference; the control (the reference in the next precision below
the configuration's, in the program's place) reads above the program, and
on the card, at the cell's own size, is judged not correct under the
cell's committed limits; every fault a cell can have, planted under the
timed path, turns `correct` false under those limits."""
import pytest
import torch

from portbench import calibrate
from portbench.harness import cell as cells, faults
from portbench.tests._tiny import tiny_cell

TRAIN = [("avt_b_h_ek100", "train_b24"), ("avt_h_tsn_ek100", "train_t256"),
         ("avt_h_tsn_ek100", "train_t10")]
SEED = 2 ** 31 + 101


def _numbers(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.mark.parametrize("config,mix", TRAIN + [("avt_b_h_ek100", "serve_req8")])
def test_port_agrees_with_reference(config, mix):
    cell = tiny_cell(config, mix)
    r = cells.run(cell, SEED, 0.05, False, "cpu")
    got = _numbers(r)
    assert [n for n in r["notes"] if not n.startswith(("set-up s:", "window:"))] == []
    assert got["launch_mismatch"] == 0
    # f32 agrees to rounding; bf16 to bf16's rounding through a whole model
    tol = 1e-5 if cell.cfg["model"]["compute_dtype"] == "float32" else 6e-2
    assert all(v <= tol for k, v in got.items()), got
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("config,mix", TRAIN + [("avt_b_h_ek100", "serve_req8")])
def test_control_reads_above_the_program(config, mix):
    cell = tiny_cell(config, mix)
    program = _numbers(cells.run(cell, SEED, 0.05, False, "cpu"))
    control = calibrate.control_numbers(cell, SEED, "cpu")
    assert any(control[k] > 1.5 * program[k] for k in control), (control, program)


@pytest.mark.parametrize("config,mix", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_train_fault_is_not_correct(config, mix, fault):
    cell = tiny_cell(config, mix)
    assert not cells.run(cell, SEED, 0.05, False, "cpu", tamper=faults.FAULTS[fault])["correct"]


@pytest.mark.parametrize("fault", ["altered_answer", "crop_offset"])
def test_serve_fault_is_not_correct(fault):
    cell = tiny_cell("avt_b_h_ek100", "serve_req8")
    assert not cells.run(cell, SEED, 0.05, False, "cpu",
                         tamper=faults.FAULTS[fault])["correct"]


@pytest.mark.parametrize("fault", ["crop_offset", "wrong_scale"])
def test_preprocessing_fault_is_not_correct(fault):
    cell = tiny_cell("avt_b_h_ek100", "train_b24")
    r = cells.run(cell, SEED, 0.05, False, "cpu", tamper=faults.FAULTS[fault])
    assert not r["correct"]
    assert r["checks"]["frames_gap"]["value"] > r["checks"]["frames_gap"]["limit"]


def test_draws_reach_both_sides():
    cell = tiny_cell("avt_b_h_ek100", "train_b24")
    r = cells.run(cell, SEED, 0.05, False, "cpu")
    assert r["checks"]["draw_mismatch"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["avt_h_tsn_ek100.train_t10", "avt_b_h_ek100.serve_req8"])
def test_cell_on_the_card(cell_name):
    """A whole run of a committed cell on the card with a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels on the card")
    r = cells.run(cells.load_cell(cell_name), SEED, 2.0, False, "cuda")
    assert r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["avt_b_h_ek100.train_b24", "avt_h_tsn_ek100.train_t256",
                                       "avt_b_h_ek100.serve_req8", "avt_h_tsn_ek100.train_t10"])
def test_control_is_not_correct_on_the_card(cell_name):
    """The control at the cell's own size, judged under its committed limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    cell = cells.load_cell(cell_name)
    ok, checks = calibrate.judged(cell, calibrate.control_numbers(cell, SEED, "cuda"))
    assert not ok, checks
