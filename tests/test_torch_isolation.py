"""The port stands alone: avt_tpu_torch and chip_smoke.py import neither JAX
(nor flax, orbax or h5py) nor the JAX package, nor PyYAML or pandas (lmdb
only inside LMDBFeatsReader.__init__, OpenCV only inside
OpenCVVideoReader.__init__ and chip_smoke.py's video writer), and its
entry points do not run on the CPU unasked."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import avt_tpu_torch
from avt_tpu_torch import VideoPreprocessor, build_avt
from avt_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    f for f in (ROOT / "avt_tpu_torch").rglob("*.py") if "_build" not in f.parts
) + [ROOT / "chip_smoke.py"]
# `avt_tpu` not followed by `_torch` (the port's own name starts the same)
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|orbax|h5py|yaml|pandas|avt_tpu(?!_torch))\b",
    re.MULTILINE)


# the config and host data layers and train_net
NEW_MODULES = (
    "import avt_tpu_torch.config, avt_tpu_torch.config.overrides, avt_tpu_torch.config.compose\n"
    "import avt_tpu_torch.config.registry, avt_tpu_torch.config.build, avt_tpu_torch.data\n"
    "import avt_tpu_torch.data.table, avt_tpu_torch.data.sampling, avt_tpu_torch.data.readers\n"
    "import avt_tpu_torch.data.anticipation, avt_tpu_torch.data.dataset\n"
    "import avt_tpu_torch.data.epic_kitchens, avt_tpu_torch.data.clip_samplers\n"
    "import avt_tpu_torch.data.loader, avt_tpu_torch.train_net\n"
    "import avt_tpu_torch.data.video_decoder, avt_tpu_torch.data.breakfast_50salads\n"
    "import avt_tpu_torch.models.import_torch\n"
    "from avt_tpu_torch.models.import_torch import init_from_model\n"
    "from avt_tpu_torch.data.readers import OpenCVVideoReader\n"
    "from avt_tpu_torch.config import Composer, instantiate\n"
    "from avt_tpu_torch.train_net import cli, main\n"
)


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'avt_tpu', 'h5py', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "import avt_tpu_torch, avt_tpu_torch.models, avt_tpu_torch.ops, avt_tpu_torch.serve\n"
        "import avt_tpu_torch.data.transforms, avt_tpu_torch.models.convert\n"
        "import avt_tpu_torch.train, avt_tpu_torch.train.optim, avt_tpu_torch.train.step\n"
        "import avt_tpu_torch.train.ops, avt_tpu_torch.losses, avt_tpu_torch.losses.xent\n"
        "import avt_tpu_torch.utils.metrics, avt_tpu_torch.ops.flash_attention\n"
        "import avt_tpu_torch.ops.attention, avt_tpu_torch.ops._build, avt_tpu_torch.models.vit\n"
        "from avt_tpu_torch.ops.flash_attention import fused_qkv_attention\n"
        "from avt_tpu_torch.train.optim import Adam, Adafactor, ReduceLROnPlateau\n"
        "from avt_tpu_torch.models.convert import opt_state_from_jax\n"
        "import avt_tpu_torch.train.loop, avt_tpu_torch.train.checkpoint\n"
        "import avt_tpu_torch.train.meters, avt_tpu_torch.evaluate, avt_tpu_torch.utils.logging\n"
        "from avt_tpu_torch.evaluate import evaluate, read_results, store_append\n"
        "from avt_tpu_torch import run_training, make_multi_step, save_checkpoint\n"
        + NEW_MODULES +
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_new_layers_import_with_yaml_pandas_and_cv2_blocked():
    """The config and data layers and train_net read YAML, csv and tables
    on their own: they import with PyYAML, pandas, OpenCV and lmdb blocked
    too, and compose expts/02 there."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'avt_tpu', 'h5py', 'orbax', 'yaml', 'pandas', 'cv2',\n"
        "             'lmdb'):\n"
        "    sys.modules[name] = None\n"
        + NEW_MODULES +
        "from avt_tpu_torch.config import parse_overrides_file\n"
        "cfg = Composer('conf').compose('config', parse_overrides_file(\n"
        "    'expts/02_ek100_avt_tsn.txt'))\n"
        "assert cfg['model']['future_predictor']['n_layer'] == 6\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imports(path, module):
    return re.findall(rf"^( *)(?:import|from) {module}\b", path.read_text(), re.MULTILINE)


def test_cv2_is_imported_by_the_opencv_reader_and_the_video_writer_alone():
    readers = ROOT / "avt_tpu_torch" / "data" / "readers.py"
    assert _imports(readers, "cv2") == ["        "]
    src = readers.read_text()
    assert src.index("import cv2") > src.index("class OpenCVVideoReader")
    assert src.rindex("def __init__", 0, src.index("import cv2")) > src.index(
        "class OpenCVVideoReader")
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert _imports(ROOT / "chip_smoke.py", "cv2") == ["    "]
    assert smoke.rindex("\ndef ", 0, smoke.index("import cv2")) == smoke.index(
        "\ndef write_video(")
    for path in PORT_FILES:
        if path.name not in ("readers.py", "chip_smoke.py"):
            assert not _imports(path, "cv2"), path


def test_lmdb_is_imported_by_the_lmdb_reader_alone():
    src = (ROOT / "avt_tpu_torch" / "data" / "readers.py").read_text()
    imports = re.findall(r"^( *)import lmdb\b", src, re.MULTILINE)
    assert imports == ["        "]  # once, inside LMDBFeatsReader.__init__
    for path in PORT_FILES:
        if path.name != "readers.py":
            assert not re.search(r"^\s*(?:import|from)\s+lmdb\b", path.read_text(), re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    src = path.read_text()
    assert not FORBIDDEN.search(src), f"{path} imports jax, flax or avt_tpu"


def test_forbidden_pattern_catches_jax_package_only():
    assert FORBIDDEN.search("from avt_tpu.ops import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    import h5py")
    assert FORBIDDEN.search("import yaml") and FORBIDDEN.search("  import pandas as pd")
    assert not FORBIDDEN.search("from avt_tpu_torch.ops import x")


def test_entry_points_refuse_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_avt(num_actions=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_avt(num_actions=4, backbone="identity")
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoPreprocessor()
    assert resolve_device("cpu") == torch.device("cpu")
    assert avt_tpu_torch.__all__
