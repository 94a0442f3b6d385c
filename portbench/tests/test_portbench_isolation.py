"""The benchmark loads no JAX, no flax and no avt_tpu (whole top-level
names: avt_tpu_torch begins with avt_tpu), and its reference nothing of the
port; a run without a card prints no result and fails."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROBE = """
import sys
before = set(sys.modules)
{imports}
print(sorted({{m.split('.')[0] for m in set(sys.modules) - before}}))
"""


def _new_top_level(imports):
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_harness_load_no_jax():
    loaded = _new_top_level("import portbench.run, portbench.harness.cell, "
                            "portbench.families.avt, portbench.calibrate, "
                            "portbench.drivers.train_steps, portbench.drivers.serve_requests")
    assert not loaded & {"jax", "jaxlib", "flax", "avt_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _new_top_level("import portbench.reference.avt, portbench.optimizers.sgd, "
                            "portbench.schedules.cosine")
    assert not loaded & {"jax", "jaxlib", "flax", "avt_tpu", "avt_tpu_torch"}


def test_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in {"jax", "jaxlib", "flax", "avt_tpu"}, (path, line)


def test_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "avt_h_tsn_ek100.train_t10", "--seed", str(2 ** 31 + 5), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert json.loads(line).get("correct") is not True
        except ValueError:
            pass
