"""tools/torch_extract_features.py's arguments, checked before any
extraction runs: a --run-dir that holds YAML syntax (`,`, `: `, `{`, `'`)
reaches the dense sampler whole as `featext_results_dir`, through the
port's override parser and the composed config; --formats takes blanks
around its names and refuses a name it does not know, such as a typo,
before extraction starts (it used to write no LMDB store and say
nothing)."""
import argparse
import os
import sys
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_extract_features as txf  # noqa: E402

from avt_tpu_torch.config import parse_override  # noqa: E402

SAMPLER = "+dataset_eval.sample_clips_densely_fn="
SAMPLER_KEYS = {"_target_", "clip_len", "stride", "keep_orig_clips", "featext_skip_done",
                "featext_results_dir", "shard_per_worker"}
RUN_DIRS = ["/runs/a,b", "/runs/x: y", "/runs/it's", "/runs/{z}", "/runs/a,b: it's {z}/0"]


def _args(run_dir):
    return argparse.Namespace(clip_len=1.0, stride=0.25, resume=False, run_dir=run_dir,
                              endpoint="temp_agg")


@pytest.mark.parametrize("run_dir", RUN_DIRS)
def test_a_run_dir_with_yaml_syntax_reaches_the_sampler_whole(run_dir):
    sampler = [o for o in txf._featext_overrides(_args(run_dir)) if o.startswith(SAMPLER)]
    assert len(sampler) == 1
    value = parse_override(sampler[0]).value
    assert set(value) == SAMPLER_KEYS
    assert value["featext_results_dir"] == os.path.join(run_dir, txf.RESULTS_DIR)
    assert value["stride"] == 0.25 and value["shard_per_worker"] is True


def test_the_composed_config_holds_the_run_dir_whole():
    run_dir = RUN_DIRS[-1]
    cfg = txf.compose_cfg(None, [], _args(run_dir), str(ROOT / "conf"))
    sampler = cfg["dataset_eval"]["sample_clips_densely_fn"]
    assert set(sampler) == SAMPLER_KEYS
    assert sampler["featext_results_dir"] == os.path.join(run_dir, txf.RESULTS_DIR)


@pytest.mark.parametrize("text,want", [("npy,lmdb", ("npy", "lmdb")),
                                       ("npy, lmdb", ("npy", "lmdb")),
                                       (" lmdb ", ("lmdb",)), ("npy", ("npy",))])
def test_formats_are_stripped(text, want):
    assert txf.parse_formats(text) == want


@pytest.mark.parametrize("text", ["ldmb", "npy, ldmb", "npy,", "NPY"])
def test_an_unknown_format_exits_before_extraction(text, tmp_path):
    run_dir = tmp_path / "run"
    with mock.patch.object(txf, "compose_cfg", side_effect=AssertionError("extraction ran")), \
            pytest.raises(SystemExit, match="formats"):
        txf.main(["--run-dir", str(run_dir), "--out", str(tmp_path / "store"), "--formats",
                  text])
    assert not run_dir.exists()


def test_npy_comma_space_lmdb_packs_both_stores(tmp_path):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / txf.INDEX_NAME).write_text("uid,video_stem,end\n")
    stats = {"rows": 0, "videos": 0, "skipped": 0}
    with mock.patch.object(txf, "pack", return_value=stats) as pack:
        assert txf.main(["--pack-only", "--no-verify", "--run-dir", str(run_dir), "--out",
                         str(tmp_path / "store"), "--formats", "npy, lmdb"]) == stats
    assert pack.call_args.kwargs["formats"] == ("npy", "lmdb")
