"""Each mix's inputs are the same for the same seed, differ for another
seed, and keep their shapes."""
import numpy as np
import pytest
import torch

from portbench.harness import traffic as gen
from portbench.tests._tiny import tiny_cell

BIG = 2 ** 31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize("config,mix", [("avt_b_h_ek100", "train_b24"),
                                        ("avt_h_tsn_ek100", "train_t256"),
                                        ("avt_h_tsn_ek100", "train_t10")])
def test_train_pool_from_seed(config, mix):
    cell = tiny_cell(config, mix)
    a, b = (gen.train_pool(cell.cfg, cell.traffic, BIG, "cpu") for _ in range(2))
    c = gen.train_pool(cell.cfg, cell.traffic, BIG + 1, "cpu")
    assert len(a) == cell.traffic["pool"]
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k]) and x[k].shape == z[k].shape
        assert not torch.equal(x["video"], z["video"])
    rows = torch.cat([x["video"].flatten(1) for x in a])
    assert len({tuple(r.tolist()) for r in rows.float()}) == rows.shape[0]  # all rows differ


def test_serve_pool_from_seed():
    cell = tiny_cell("avt_b_h_ek100", "serve_req8")
    a, b = (gen.serve_pool(cell.cfg, cell.traffic, BIG, "cpu") for _ in range(2))
    c = gen.serve_pool(cell.cfg, cell.traffic, 7, "cpu")
    assert all(np.array_equal(x, y) and x.dtype == np.uint8 for x, y in zip(a, b))
    assert all(x.shape == z.shape and not np.array_equal(x, z) for x, z in zip(a, c))


def test_p95_nearest_rank():
    assert gen.p95(list(range(1, 101))) == 95
    assert gen.p95([3.0]) == 3.0
    assert gen.p95(list(range(1, 21))) == 19


def test_mixed_sizes_same_for_every_seed():
    tr = {"clips": [1, 2, 4, 16], "pool": 8}
    a, b = gen.sizes(tr, BIG), gen.sizes(tr, 7)
    assert sorted(a) == sorted(b) == sorted([1, 2, 4, 16] * 2)
    assert a == gen.sizes(tr, BIG)
    assert gen.sizes({"clips": 8, "pool": 3}, BIG) == [8, 8, 8]


def test_arrivals_from_seed():
    assert gen.arrivals({"arrival": {"kind": "closed"}}, BIG) is None
    tr = {"arrival": {"kind": "poisson", "rate_per_s": 50.0, "burst": 2}}
    a = [t for _, t in zip(range(400), gen.arrivals(tr, BIG))]
    b = [t for _, t in zip(range(400), gen.arrivals(tr, BIG))]
    assert a == b and a == sorted(a) and a[0] == a[1]  # bursts of two
    assert 400 / a[-1] == pytest.approx(50.0, rel=0.2)


def test_frames_have_texture_down_to_the_pixel():
    g = torch.Generator().manual_seed(3)
    x = gen.frames(4, 64, 96, 3, g, "cpu").float()
    assert x.shape == (4, 64, 96, 3) and 30 < x.std() < 70
    # a one-pixel shift moves a frame by a sizeable share of its contrast
    shifted = (x[:, :, 1:] - x[:, :, :-1]).abs().mean() / x.std()
    assert shifted > 0.1


def test_open_loop_mixed_requests_through_a_run():
    from portbench.harness import cell as cells

    cell = tiny_cell("avt_b_h_ek100", "serve_req8", clips=[1, 3, 2], batch=2, pool=6,
                     arrival={"kind": "poisson", "rate_per_s": 40.0, "burst": 2})
    r = cells.run(cell, BIG, 0.3, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
