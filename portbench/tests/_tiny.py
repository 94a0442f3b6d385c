"""Tiny cells for the CPU tests: the configurations' structure at sizes a
test run holds (the widths cut, which no benchmark cell may do)."""
import copy
import json
from pathlib import Path

from portbench.harness import cell as cells

PKG = Path(__file__).resolve().parents[1]
TINY_MODEL = {"vit_width": 32, "vit_depth": 2, "vit_heads": 2, "img_size": 32,
              "patch_size": 16, "inter_dim": 32, "n_layer": 2, "n_head": 2,
              "num_actions": 11}


def tiny_cell(config: str, traffic: str, **traffic_overrides) -> cells.Cell:
    cfg = json.loads((PKG / "configs" / f"{config}.json").read_text())
    cfg["model"].update({k: v for k, v in TINY_MODEL.items()
                         if k in cfg["model"] or cfg["model"]["backbone"] == "avt_b"})
    if cfg["model"]["backbone"] == "avt_b":
        cfg["model"]["backbone_dim"] = TINY_MODEL["vit_width"]
        cfg["input"]["frame_shape"] = [36, 48, 3]
        cfg["preprocess"].update(train_scale=[33, 38], eval_scale=34, crop=32)
    else:
        cfg["model"]["backbone_dim"] = cfg["input"]["feature_dim"] = 16
    cfg["reference"]["block_clips"] = 2
    tr = json.loads((PKG / "traffic" / f"{traffic}.json").read_text())
    tr.update(clips=4, length=3, pool=4, check_requests=2, profile_units=2)
    tr.update(traffic_overrides)
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    name = f"{config}.{traffic}"
    limits = json.loads((PKG / "limits" / f"{name}.json").read_text())
    cell = cells.Cell(name, cfg, tr, limits,
                      [m for m in bench["end_to_end"] if cells._applies(m, name)],
                      [m for m in bench["per_layer"] if cells._applies(m, name)])
    return cells.attach(copy.deepcopy(cell))
