"""Data parallelism over processes in the port (avt_tpu_torch/parallel/ddp.py,
the multi-process branches of train/, evaluate/, models/norm.py,
losses/infonce.py, train_net.py and launch.py) on the CPU over gloo.

Two spawned runs hold two ranks of b clips against one process on the 2b
clips, which is what the JAX package's step computes over the global batch:
  * tests/_torch_ddp_worker.py's checks: the step generators, BatchNorm's
    batch and running statistics and gradients, the InfoNCE loss and its
    gradient with the negatives of both ranks, two train steps with
    position-stable dropout live (losses and parameters), the meters;
  * `python -m avt_tpu_torch.launch -c expts/02_ek100_avt_tsn.txt --spawn 2`
    on a synthetic EK100 tree against `train_net.cli`: the checkpoint, the
    merged eval results, and a resume of that checkpoint on both ranks.
The one-process step is held against avt_tpu's on the same global batch.
Tolerances: f32, the same sums taken in another order (per rank, then over
the ranks) or, for BatchNorm, as sums of squares rather than torch's
two-pass variance."""
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.models.backbones import IdentityBackbone as JIdentityBackbone
from avt_tpu.train import TrainState
from avt_tpu.train import build_optimizer as jbuild_optimizer
from avt_tpu.train import make_train_step as jmake_train_step
from avt_tpu_torch import launch, train_net
from avt_tpu_torch.evaluate import RESULTS_SAVE_DIR, read_results
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.parallel import ddp
from avt_tpu_torch.parallel.mesh import Mesh, current_mesh, make_mesh
from avt_tpu_torch.train import CKPT_NAME, build_optimizer, make_train_step

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import _torch_ddp_worker as worker  # noqa: E402
import chip_smoke  # noqa: E402

WORLD, B_GLOBAL = 2, 4
EXPT = str(ROOT / chip_smoke.EXPT_02)
TOL = 2e-5  # of each array's max |one-process value|


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = dict(bn_x=(rng.standard_normal((B_GLOBAL, 3, 2, 3, 3)) * 2 + 1).astype(f32),
                  bn_w=rng.standard_normal((B_GLOBAL, 4, 2, 3, 3)).astype(f32),
                  nce_out=rng.standard_normal((B_GLOBAL, 8)).astype(f32),
                  nce_tgt=rng.standard_normal((B_GLOBAL, 2, 8)).astype(f32))
    for j in range(2):
        inputs[f"video{j}"] = rng.standard_normal(
            (B_GLOBAL, worker.T, worker.FEAT, 1, 1, 1)).astype(f32)
        inputs[f"target{j}"] = rng.integers(0, worker.N_CLS, size=B_GLOBAL)
        # no ignored targets: a per-rank mean over kept rows is not the global one
        inputs[f"tsub{j}"] = rng.integers(0, worker.N_CLS, size=(B_GLOBAL, worker.T, 1))
    return inputs


def _spawn(cmd, tmp_path, timeout=300):
    """Runs `cmd` as WORLD ranks of one gloo group; returns their outputs."""
    port = launch._free_port()
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(os.environ, PYTHONPATH=str(ROOT),
                                                  **launch.rank_env(r, WORLD, r, "localhost",
                                                                    port)))
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's and rank 1's checks, the one-process checks on the global
    batch)."""
    tmp = tmp_path_factory.mktemp("ddp")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    _spawn([sys.executable, str(ROOT / "tests" / "_torch_ddp_worker.py"),
            str(tmp / "inputs.npz"), str(tmp)], tmp)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    assert ddp.world_size() == 1
    return ranks, worker.run_checks(inputs)


def _rows(x, r):
    n = x.shape[0] // WORLD
    return x[r * n:(r + 1) * n]


def test_rank_generators_differ_and_share_the_one_process_draws(runs):
    ranks, one = runs
    assert not np.array_equal(ranks[0]["draw_own"], ranks[1]["draw_own"])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["draw_shared"], one["draw_own"])
        assert not np.array_equal(ranks[r]["draw_own"], one["draw_own"])
    # in one process the shared generator is the step's own: today's bits
    np.testing.assert_array_equal(one["draw_shared"], one["draw_own"])


def test_batch_norm_takes_the_global_statistics(runs):
    """The counterpart of test_bn_sharded_equals_global_stats: two train
    steps of conv + BatchNorm on the ranks' halves equal one torch
    BatchNorm on the whole batch, outputs, running mean and (unbiased)
    variance, step count and gradients."""
    ranks, one = runs
    for r in range(WORLD):
        for i in range(2):
            _close(ranks[r][f"bn_y{i}"], _rows(one[f"bn_y{i}"], r), f"rank {r} BN output {i}")
        for key in ("bn_running_mean", "bn_running_var", "bn_dconv", "bn_dweight", "bn_dbias"):
            _close(ranks[r][key], one[key], f"rank {r} {key}")
        assert int(ranks[r]["bn_tracked"]) == int(one["bn_tracked"]) == 2


def test_infonce_takes_the_negatives_of_every_rank(runs):
    """The counterpart of test_spawn_two_process_ssl_infonce_equals_single_
    process: the mean of the ranks' losses is the global batch's, and a
    rank's gradient, averaged over the ranks as the step does, is the
    global gradient of its rows."""
    ranks, one = runs
    _close(np.mean([ranks[r]["nce_loss"] for r in range(WORLD)]), one["nce_loss"], "loss")
    for r in range(WORLD):
        _close(ranks[r]["nce_dout"] / WORLD, _rows(one["nce_dout"], r), f"rank {r} d output")
        _close(ranks[r]["nce_dtgt"] / WORLD, _rows(one["nce_dtgt"], r), f"rank {r} d target")


def test_train_steps_match_one_process_on_the_global_batch(runs):
    """Two steps with position-stable dropout live: the ranks' mean losses
    and both ranks' parameters equal the one-process run's, since the masks
    are keyed by the shared step generator and the global row."""
    ranks, one = runs
    for j in range(2):
        for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
            _close(np.mean([ranks[r][f"step{j}/{key}"] for r in range(WORLD)]),
                   one[f"step{j}/{key}"], f"step {j} {key}")
    names = [k for k in one if k.startswith("param/")]
    assert names
    for name in names:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])  # one update on both
        _close(ranks[0][name], one[name], name)


def test_meters_sum_over_the_ranks(runs):
    ranks, one = runs
    want = [(1.0 + 2.0) / 2, (0.0 * 2 + 0.5 * 3) / 5, 5]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["meters"], want, rtol=1e-5)
    np.testing.assert_allclose(one["meters"], [1.0, 0.0, 2], rtol=1e-5, atol=1e-6)


def test_one_process_step_matches_avt_tpu_on_the_global_batch():
    """The one-process side of the comparisons above against avt_tpu's
    make_train_step on the same weights and global batch (dropout off,
    whose masks the two packages draw differently): losses and updates."""
    jm = JAVTModel(
        backbone=JIdentityBackbone(), temporal_aggregator=JIdentityAgg(in_features=worker.FEAT),
        future_predictor=JAVTh(in_features=worker.FEAT, output_len=2, avg_last_n=1,
                               return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                               resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **worker.AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=worker.FEAT),
        classifiers={"action": JLinearClassifier(out_features=worker.N_CLS)},
        num_classes=(("action", worker.N_CLS),), backbone_dim=worker.FEAT, dropout=0.0,
        classifier_on_past=True)
    inputs = _inputs()
    jb = {"video": jnp.asarray(inputs["video0"]),
          "target": {"action": jnp.asarray(inputs["target0"])},
          "target_subclips": {"action": jnp.asarray(inputs["tsub0"])}}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb["video"], (B_GLOBAL,))
    tx, _ = jbuild_optimizer(params, **worker.OPT)
    jstep = jmake_train_step(jm, tx, worker.LOSS_WTS, {"action": worker.N_CLS}, donate=False)
    new_state, jmetrics = jstep(TrainState.create(params, tx), jb, jax.random.PRNGKey(1))

    model = load_jax_params(worker.feature_model(pdrop=0.0, output_len=2), params)
    opt, _ = build_optimizer(model, **worker.OPT)
    metrics = make_train_step(model, opt, worker.LOSS_WTS, {"action": worker.N_CLS})(
        worker.torch_batch(inputs, 0))
    for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    before, after = params_from_jax(params), params_from_jax(new_state.params)
    for name, p in model.named_parameters():
        want = np.asarray(after[name]) - np.asarray(before[name])
        _close(p.detach().numpy() - np.asarray(before[name]), want, f"update {name}", tol=2e-4)


# ------------------------------------------------------------ the launcher
DIM = 32
COMMON = ["model.backbone_dim=32", "model.future_predictor.n_layer=2",
          "model.future_predictor.inter_dim=32", "model.future_predictor.n_head=2",
          "data_train.workers=0", "data_eval.workers=0", "opt.scale_lr_by_bs=true",
          "model.dropout=0.0", "+model.future_predictor.embd_pdrop=0.0",
          "+model.future_predictor.attn_pdrop=0.0", "+model.future_predictor.resid_pdrop=0.0"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ek100")
    return chip_smoke.write_ek100_tree(str(root), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=12, dim=DIM, seed=4)


def _ckpt(run_dir):
    return torch.load(Path(run_dir) / CKPT_NAME, map_location="cpu", weights_only=True)


def test_launch_spawns_two_ranks_that_match_one_process(tree, tmp_path, monkeypatch):
    """expts/02 through `launch --spawn 2` (2 + 2 clips a step over gloo)
    and through `train_net.cli` in one process (4 clips a step), at the same
    LR (scale_lr_by_bs: 2 ranks x 2 = 1 x 4): the checkpoint rank 0 wrote,
    and the eval results both ranks appended, merged; then a second epoch,
    which both ranks resume from that checkpoint."""
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    ddp_dir, one_dir = tmp_path / "ddp", tmp_path / "one"
    for epochs in (1, 2):
        extra = tree + COMMON + [f"train.num_epochs={epochs}"]
        rcs = launch.main(["-c", EXPT, "--spawn", str(WORLD), "--run-dir", str(ddp_dir)]
                          + extra + ["train.batch_size=2", "eval.batch_size=2"])
        assert rcs == [0, 0]
        train_net.cli(["--config-file", EXPT, "--run-dir", str(one_dir)] + extra
                      + ["train.batch_size=4", "eval.batch_size=4"])
        got, want = _ckpt(ddp_dir), _ckpt(one_dir)
        assert got["epoch"] == want["epoch"] == float(epochs)
        assert set(got["model"]) == set(want["model"])
        for name, v in want["model"].items():
            _close(got["model"][name].numpy(), v.numpy(), f"epoch {epochs} {name}", tol=1e-4)
        res, ref = read_results(str(ddp_dir / RESULTS_SAVE_DIR)), read_results(
            str(one_dir / RESULTS_SAVE_DIR))
        assert sorted(os.listdir(ddp_dir / RESULTS_SAVE_DIR)) == ["0", "1"]
        np.testing.assert_array_equal(res["idx"], ref["idx"])
        _close(res["logits/action"], ref["logits/action"], f"epoch {epochs} eval logits",
               tol=1e-4)
    # the second launch resumed: rank 0 logs it (the other ranks log warnings
    # only); a rank that had not would have trained two epochs to rank 0's
    # one, out of step in its collectives, and the checkpoints would differ
    log = (ddp_dir / "rank0.log").read_text()
    assert "Resumed from epoch 1.0000" in log, log[-2000:]
    assert not list(ddp_dir.glob("run*.pid"))


# ------------------------------------------------------- without a group
def test_helpers_in_one_process_and_their_refusals(monkeypatch):
    assert (ddp.rank(), ddp.world_size()) == (0, 1)
    for key in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS"):
        monkeypatch.delenv(key, raising=False)
    assert ddp.setup_distributed("gloo", "cpu") is False  # no rendezvous: a no-op
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        ddp.setup_distributed("gloo", "cpu")
    assert ddp.resolve_backend("ici", "cuda") == "nccl"
    assert ddp.resolve_backend(None, "cpu") == "gloo"
    assert ddp.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        ddp.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="mpi"):
        ddp.resolve_backend("mpi", "cpu")
    with pytest.raises(ValueError, match="model_size=4 does not divide the 1 processes"):
        make_mesh(4)
    assert make_mesh(1) == current_mesh() == Mesh(1, 1, 0, 0)
    assert (ddp.data_rank(), ddp.data_world(), ddp.model_rank()) == (0, 1, 0)
    x = torch.arange(6.0).reshape(3, 2)
    assert ddp.all_gather_with_grad(x) is x and ddp.all_reduce_with_grad(x) is x
    assert ddp.from_rank0(True) and ddp.any_rank(True) and not ddp.any_rank(False)


def test_launch_print_cmd_and_slurm(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    expt = tmp_path / "e.txt"
    expt.write_text("train.batch_size=4\nhydra.launcher.nodes=2\nhydra.launcher.gpus_per_node=4\n")
    launch.main(["-c", str(expt), "--print-cmd", "--master", "h0:2345"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for node, line in enumerate(lines):
        assert f"--node-rank {node}" in line and "--nproc-per-node 4" in line
        assert "--master-addr h0 --master-port 2345" in line and "avt_tpu_torch.train_net" in line
        assert "avt_tpu.train_net" not in line
    path = launch.main(["-c", str(expt), "--slurm"])
    script = Path(path).read_text()
    assert "export MASTER_ADDR=" in script and "--ntasks-per-node=4" in script
    assert "-m avt_tpu_torch.train_net" in script and "JAX_" not in script
    sweep = tmp_path / "s.txt"
    sweep.write_text("hydra.launcher.nodes=1,2\n")
    with pytest.raises(ValueError, match="differs across the sweep"):
        launch.main(["-c", str(sweep), "--slurm"])


def test_launch_submit_and_kill_keep_the_job_record_on_failure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    expt = tmp_path / "k.txt"
    expt.write_text("train.batch_size=4\n")
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="4242;cluster\n", stderr="")

    with mock.patch.object(launch.subprocess, "run", fake_run):
        assert launch.main(["-c", str(expt), "--slurm", "--submit"]) == "4242"
    assert ran[0][:2] == ["sbatch", "--parsable"]
    job_file = Path(launch.output_dir_for(str(expt))) / "slurm_job_ids"
    assert job_file.read_text() == "4242\n"
    with mock.patch.object(launch.shutil, "which", lambda name: "/bin/scancel"), \
            mock.patch.object(launch.subprocess, "call", lambda cmd: 1):
        assert launch.main(["-c", str(expt), "--kill"]) == 0
    assert job_file.read_text() == "4242\n"  # scancel failed: the record stays
    with mock.patch.object(launch.shutil, "which", lambda name: "/bin/scancel"), \
            mock.patch.object(launch.subprocess, "call", lambda cmd: 0):
        assert launch.main(["-c", str(expt), "--kill"]) == 1
    assert not job_file.exists()


def test_launch_never_runs_the_jax_trainer():
    src = (ROOT / "avt_tpu_torch" / "launch.py").read_text()
    assert launch.TRAIN_MODULE == "avt_tpu_torch.train_net"
    assert not re.search(r"avt_tpu\.train_net", src)


def test_the_new_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'avt_tpu', 'h5py', 'orbax'):\n"
            "    sys.modules[name] = None\n"
            "import avt_tpu_torch.parallel, avt_tpu_torch.parallel.ddp, avt_tpu_torch.launch\n"
            "import avt_tpu_torch.serve\n"
            "from avt_tpu_torch.serve import export_eval_forward, load_exported, serving_fn\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
