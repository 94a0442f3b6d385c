"""The port stands alone: avt_tpu_torch and chip_smoke.py import neither JAX
nor the JAX package, and its entry points do not run on the CPU unasked."""
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
    r"^\s*(?:import|from)\s+(?:jax|flax|avt_tpu(?!_torch))\b", re.MULTILINE)


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'avt_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import avt_tpu_torch, avt_tpu_torch.models, avt_tpu_torch.ops, avt_tpu_torch.serve\n"
        "import avt_tpu_torch.data.transforms, avt_tpu_torch.models.convert\n"
        "import avt_tpu_torch.train, avt_tpu_torch.train.optim, avt_tpu_torch.train.step\n"
        "import avt_tpu_torch.train.ops, avt_tpu_torch.losses, avt_tpu_torch.losses.xent\n"
        "import avt_tpu_torch.utils.metrics, avt_tpu_torch.ops.flash_attention\n"
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
