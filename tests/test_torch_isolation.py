"""The port stands alone: avt_tpu_torch, its tools (tools/torch_*.py) and
chip_smoke.py import neither JAX (nor flax, orbax or h5py) nor the JAX
package, nor PyYAML or pandas (lmdb only inside the functions that read or
write an LMDB store, OpenCV only inside OpenCVVideoReader.__init__, the
video writers and analysis.overlay_text, matplotlib and seaborn only inside
the functions that draw), and its entry points do not run on the CPU
unasked."""
import ast
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
) + sorted((ROOT / "tools").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
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


def _importers(module):
    """{(file name, enclosing function): count} of every import of `module`
    in the port's files; the function is '<module>' at the top level."""
    found = {}
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        stack = [(tree, "<module>")]
        while stack:
            node, where = stack.pop()
            for child in ast.iter_child_nodes(node):
                inner = where
                if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                    inner = child.name if where == "<module>" else f"{where}.{child.name}"
                names = ([a.name for a in child.names] if isinstance(child, ast.Import) else
                         [child.module] if isinstance(child, ast.ImportFrom) and child.module
                         else [])
                if any(n == module or n.startswith(module + ".") for n in names):
                    key = (path.name, inner)
                    found[key] = found.get(key, 0) + 1
                stack.append((child, inner))
    return found


def test_cv2_is_imported_by_the_opencv_reader_and_the_video_writer_alone():
    assert _importers("cv2") == {
        ("readers.py", "OpenCVVideoReader.__init__"): 1,
        ("chip_smoke.py", "write_video"): 1,
        ("analysis.py", "overlay_text"): 1,
        ("torch_smoke_train.py", "make_video_dataset"): 1,
    }
    assert _imports(ROOT / "avt_tpu_torch" / "data" / "readers.py", "cv2") == ["        "]


def test_lmdb_is_imported_by_the_lmdb_reader_alone():
    """The reader's constructor and the tools' store writer and reader."""
    assert _importers("lmdb") == {
        ("readers.py", "LMDBFeatsReader.__init__"): 1,
        ("torch_extract_features.py", "_open_lmdb_store"): 1,
        ("torch_compute_centroids.py", "_load_lmdb"): 1,
    }


def test_plotting_libraries_are_imported_by_the_functions_that_draw():
    assert _importers("matplotlib") == {
        ("analysis.py", "plot_per_cls_perf"): 2,
        ("torch_viz_attention.py", "render_heads"): 2,
        ("torch_viz_attention.py", "render_overlay"): 2,
    }
    assert _importers("seaborn") == {("analysis.py", "save_graph"): 1}


def test_analysis_and_tools_import_with_pandas_and_the_plotting_libraries_blocked():
    """The offline analysis and the tools import with pandas, matplotlib,
    seaborn, OpenCV and lmdb blocked, and JAX and its package too."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'avt_tpu', 'h5py', 'orbax', 'yaml', 'pandas', 'cv2',\n"
        "             'lmdb', 'matplotlib', 'seaborn'):\n"
        "    sys.modules[name] = None\n"
        "sys.path.insert(0, 'tools')\n"
        "import avt_tpu_torch.evaluate.analysis\n"
        "from avt_tpu_torch.evaluate import read_all_results, get_epoch_from_resdir\n"
        "from avt_tpu_torch.evaluate import get_logits_from_results\n"
        "import torch_extract_features, torch_compute_centroids, torch_viz_attention\n"
        "import torch_smoke_train, torch_export_model\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


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
