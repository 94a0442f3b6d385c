"""Tensor parallelism in the port (avt_tpu_torch/parallel/mesh.py, the
tensor-parallel forms of models/, train/optim.py, train/checkpoint.py,
evaluate/, train_net.py and launch.py) on the CPU over gloo.

Two spawned runs of tests/_torch_tp_worker.py, 1 x 2 (one replica, 2
model ranks) and 2 x 2 (2 replicas of 2), serve every check:
  * two SGD steps and one Adafactor step, both with gradient clipping,
    against the JAX package's own tensor parallelism (`make_mesh(1, 2)` /
    `make_mesh(2, 2)` with `shard_params`) from the same numpy weights and
    batch, dropout 0: losses, parameters and optimizer state;
  * the 1 x 2 run with every dropout live against the port's one process
    (the same draws): losses and parameters after two steps, eval logits
    and attention maps, the KV-cache rollout;
  * the state round trip and checkpoints across model sizes.
The sharded parameter set is held against what JAX's DEFAULT_PARAM_RULES
match through the converter's names, and `launch --spawn 2
parallel.model_size=2` of expts/02 against `train_net.cli` in one process.
Tolerance: 2e-5 of each array's max |reference value| (f32: the same sums
in another order, a row layer's partial products summed over the ranks).
"""
import os
import shutil
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
    TransformerAgg as JTransformerAgg,
    ViT as JViT,
)
from avt_tpu.parallel import make_mesh as jmake_mesh, shard_batch, shard_params
from avt_tpu.parallel.mesh import DEFAULT_PARAM_RULES as JRULES, _path_str, param_spec
from avt_tpu.train import TrainState
from avt_tpu.train import build_optimizer as jbuild_optimizer
from avt_tpu.train import make_train_step as jmake_train_step
from avt_tpu_torch import launch, train_net
from avt_tpu_torch.evaluate import RESULTS_SAVE_DIR, read_results
from avt_tpu_torch.models.convert import params_from_jax
from avt_tpu_torch.parallel import ddp
from avt_tpu_torch.parallel.mesh import Mesh, make_mesh, plan_shards, shard_model
from avt_tpu_torch.train import CKPT_NAME

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import _torch_tp_worker as worker  # noqa: E402
import chip_smoke  # noqa: E402

TOL = 2e-5  # of each array's max |reference value|
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


def _jmodel():
    """worker.jax_model in the JAX package."""
    return JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=worker.DIM, depth=2,
                      num_heads=worker.HEADS),
        temporal_aggregator=JIdentityAgg(in_features=worker.DIM),
        future_predictor=JAVTh(in_features=worker.DIM, output_len=1, avg_last_n=1,
                               return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                               resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **worker.AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=worker.DIM),
        classifiers={"action": JLinearClassifier(out_features=worker.N_CLS)},
        num_classes=(("action", worker.N_CLS),), backbone_dim=worker.DIM, dropout=0.0,
        classifier_on_past=True)


def _jbatch(inputs, j):
    return {"video": jnp.asarray(inputs[f"video{j}"]),
            "target": {"action": jnp.asarray(inputs[f"target{j}"])},
            "target_subclips": {"action": jnp.asarray(inputs[f"tsub{j}"])}}


def _inputs():
    """Two global batches of 4 flagship-shaped clips (1-frame clips, 4 a
    sample; no ignored targets: a replica's mean over kept rows would not
    be the global one) and the JAX model's initial weights as `init/<port
    name>`; returns (inputs, JAX params)."""
    rng = np.random.default_rng(0)
    inputs = {}
    for j in range(2):
        inputs[f"video{j}"] = rng.standard_normal(
            (worker.B, worker.CLIPS, 3, 1, 32, 32)).astype(np.float32)
        inputs[f"target{j}"] = rng.integers(0, worker.N_CLS, size=worker.B)
        inputs[f"tsub{j}"] = rng.integers(0, worker.N_CLS, size=(worker.B, worker.CLIPS, 1))
    params = jax.jit(_jmodel().init)(jax.random.PRNGKey(0), jnp.asarray(inputs["video0"]),
                                     (worker.B,))
    for name, v in params_from_jax(params).items():
        inputs[f"init/{name}"] = v.numpy()
    return inputs, params


def _spawn(world, n_model, inputs_path, out_dir):
    """Starts `world` worker ranks of one gloo group; returns the processes."""
    port = launch._free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_tp_worker.py"), str(inputs_path),
         str(out_dir), str(n_model)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, **launch.rank_env(r, world, r, "localhost", port)))
        for r in range(world)]


def _wait(procs, timeout=300):
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


def _jax_runs(inputs, params):
    """The JAX package's TP runs: per mesh, SGD's losses and parameters
    after each of two steps, Adafactor's after one."""
    jm = _jmodel()
    runs = {}
    for label, shape in MESHES.items():
        mesh = jmake_mesh(*shape)
        for name, kw, steps in (("sgd", worker.SGD, 2), ("adafactor", worker.ADAFACTOR, 1)):
            tx, _ = jbuild_optimizer(params, **kw)
            step = jmake_train_step(jm, tx, worker.LOSS_WTS, {"action": worker.N_CLS},
                                    donate=False)
            state = TrainState.create(shard_params(params, mesh), tx)
            assert any("model" in str(leaf.sharding.spec) for leaf in jax.tree.leaves(
                state.params))
            metrics = []
            for j in range(steps):
                state, m = step(state, shard_batch(_jbatch(inputs, j), mesh),
                                jax.random.PRNGKey(j))
                metrics.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
            runs[label, name] = (metrics, params_from_jax(jax.device_get(state.params)))
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{'one': the one-process checks, '1x2' / '2x2': each rank's checks,
    'jax': the JAX runs, 'tmp': the directory}. The workers run while the
    JAX package compiles its steps."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs, params = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    one = worker.run_checks(inputs, 1, save_dir=str(tmp / "ckpt_one"))
    procs = {}
    for label, (n_data, n_model) in MESHES.items():
        out_dir = tmp / label
        shutil.copytree(tmp / "ckpt_one", out_dir / "ckpt_one")
        procs[label] = _spawn(n_data * n_model, n_model, tmp / "inputs.npz", out_dir)
    jax_runs = _jax_runs(inputs, params)
    res = {"one": one, "jax": jax_runs, "tmp": tmp}
    for label, (n_data, n_model) in MESHES.items():
        _wait(procs[label])
        res[label] = [dict(np.load(tmp / label / f"rank{r}.npz"))
                      for r in range(n_data * n_model)]
    assert ddp.world_size() == 1
    return res


def _replica_mean(ranks, key, n_model):
    """A metric's mean over the data replicas (model peers hold the same)."""
    return np.mean([ranks[r][key] for r in range(0, len(ranks), n_model)])


@pytest.mark.parametrize("label", list(MESHES))
def test_the_ranks_form_the_mesh_jax_orders(runs, label):
    n_data, n_model = MESHES[label]
    for r, rank in enumerate(runs[label]):
        np.testing.assert_array_equal(rank["mesh"], [n_data, n_model, r // n_model, r % n_model])
        assert list(rank["sharded"]) == list(runs[label][0]["sharded"])
        assert len(rank["sharded"]) == 2 * 4 + 2 * 4 + 1  # 2 ViT and 2 GPT-2 blocks, classifier


@pytest.mark.parametrize("label,opt,steps", [
    ("1x2", "sgd", 2), ("2x2", "sgd", 2), ("1x2", "adafactor", 1), ("2x2", "adafactor", 1)])
def test_training_matches_jax_tensor_parallelism(runs, label, opt, steps):
    """The port's ranks against the JAX package's mesh of the same shape:
    each step's mean losses, and every parameter (gathered) after the last
    step, equal on every rank."""
    jmetrics, jparams = runs["jax"][label, opt]
    ranks, n_model = runs[label], MESHES[label][1]
    for j in range(steps):
        for key, want in jmetrics[j].items():
            _close(_replica_mean(ranks, f"{opt}/step{j}/{key}", n_model), want,
                   f"{label} {opt} step {j} {key}")
    init = np.load(runs["tmp"] / "inputs.npz")
    for name, want in jparams.items():
        want = want.numpy()
        for r, rank in enumerate(ranks):
            got, ref = rank[f"{opt}/param/{name}"], want
            if opt == "adafactor" and name.endswith(("attn.qkv.bias", "attn.c_attn.bias")):
                # the key bias shifts every score of a query alike, so its
                # gradient is 0 but for rounding, and Adafactor's first step
                # is g / sqrt(g^2 + 1e-30) * lr on it: rounding's sign and
                # size, on either side, and in one process. Held to the
                # step's bound, the largest JAX step
                c = want.shape[0] // 3
                k0 = init[f"init/{name}"][c:2 * c]
                bound = np.abs(want[c:2 * c] - k0).max()
                assert 0 < np.abs(got[c:2 * c] - k0).max() <= bound * (1 + 1e-3), name
                got, ref = np.delete(got, np.s_[c:2 * c]), np.delete(want, np.s_[c:2 * c])
            _close(got, ref, f"{label} {opt} rank {r} {name}")
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[f"{opt}/param/{name}"],
                                          ranks[0][f"{opt}/param/{name}"])


def test_clipping_is_active_in_the_jax_comparison():
    """The global norm decides the comparison's updates: the first batch's
    gradient norm exceeds grad_clip_max_norm, so every step is clipped."""
    from avt_tpu_torch.train import make_train_step

    inputs, _ = _inputs()
    model = worker._loaded(worker.jax_model(), inputs, "init/")
    opt = mock.MagicMock()
    make_train_step(model, opt, worker.LOSS_WTS, {"action": worker.N_CLS})(
        worker.batch(inputs, 0))
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    assert norm > 2 * worker.SGD["grad_clip_max_norm"]


def test_one_process_equals_the_1x2_run_with_dropout_live(runs):
    """Every dropout live, a rollout of 2: the 1 x 2 ranks draw the
    one-process masks (full-width draws sliced inside the sharded
    attentions, position-stable masks keyed by global channel), so losses,
    parameters, eval logits, attention maps and the KV-cache rollout equal
    the one-process run's."""
    one, ranks = runs["one"], runs["1x2"]
    keys = [k for k in one if k.startswith(("live/", "eval/", "eval_cache/"))]
    assert any(k.startswith("live/param/") for k in keys) and "eval/gpt2_att_1" in keys
    for rank in ranks:
        for key in keys:
            _close(rank[key], one[key], f"1x2 {key}")


@pytest.mark.parametrize("label", list(MESHES))
def test_state_round_trips_and_checkpoints_cross_model_sizes(runs, label):
    """shard_state_dict then gather_state_dict gives back the model and
    optimizer state bit for bit; a one-process checkpoint resumes on the
    ranks (parameters and momentum equal the file bit for bit), and the
    checkpoint the ranks wrote resumes in one process, equal to the
    one-process run within the tolerance."""
    from avt_tpu_torch.train import build_optimizer
    from avt_tpu_torch.train.checkpoint import restore_checkpoint

    one, ranks = runs["one"], runs[label]
    ckpt = torch.load(runs["tmp"] / "ckpt_one" / CKPT_NAME, map_location="cpu",
                      weights_only=True)
    for rank in ranks:
        assert bool(rank["roundtrip/model"]) and bool(rank["roundtrip/optimizer"])
        assert float(rank["resumed/epoch"]) == 2.0
        for name, v in ckpt["model"].items():
            np.testing.assert_array_equal(rank[f"resumed/param/{name}"], v.numpy(), name)
        for name, v in ckpt["optimizer"]["momentum"].items():
            np.testing.assert_array_equal(rank[f"resumed/momentum/{name}"], v.numpy(), name)
    model = worker.jax_model()
    opt, _ = build_optimizer(model, **worker.SGD)
    assert restore_checkpoint(str(runs["tmp"] / label / f"ckpt_tp{MESHES[label][1]}"),
                              model, opt) == 2.0
    for name, v in model.state_dict().items():
        _close(v.numpy(), one[f"sgd/param/{name}"], f"{label} checkpoint {name}")
    for name, v in opt.state["momentum"].items():
        _close(v.numpy(), one[f"sgd/momentum/{name}"], f"{label} checkpoint momentum {name}")


# ------------------------------------------------------- the rules
def _jflagship():
    """worker.flagship in the JAX package (shapes only)."""
    return JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=worker.DIM, depth=2,
                      num_heads=worker.HEADS),
        temporal_aggregator=JIdentityAgg(in_features=worker.DIM),
        future_predictor=JAVTh(in_features=worker.DIM, output_len=2, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **worker.AVTH),
        temporal_aggregator_after_future_pred=JTransformerAgg(
            in_features=worker.DIM, inter_rep=64, nheads=worker.HEADS, nlayers=1, ffn_dim=128),
        classifiers={"action": JLinearClassifier(out_features=worker.N_CLS)},
        num_classes=(("action", worker.N_CLS),), backbone_dim=worker.DIM)


def _jax_sharded_names(jm, video, n_model):
    """The port names of the parameters that JAX's rules shard over n_model
    (each leaf probed with its index through the converter)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), video, (video.shape[0],))
    paths = []

    def probe(path, leaf):
        paths.append(_path_str(path))
        return np.full(leaf.shape, len(paths) - 1, np.float32)

    probed = jax.tree_util.tree_map_with_path(probe, shapes)
    sharded = set()
    for name, x in params_from_jax(probed).items():
        i = int(x.reshape(-1)[0])
        leaf = jax.tree_util.tree_leaves(probed)[i]
        spec = param_spec(paths[i], leaf, JRULES)
        if any(a is not None and leaf.shape[d] % n_model == 0 for d, a in enumerate(spec)):
            sharded.add(name)
    return sharded


def test_sharded_parameters_are_what_jax_rules_shard():
    """The small flagship (ViT of 2 blocks of 4 heads of 32, AVT-h of 2
    layers, a Transformer aggregator, a linear classifier): the port's
    sharded names are exactly the JAX params that DEFAULT_PARAM_RULES
    shard, through the converter's names; the Transformer's attention is
    among them (JAX's `attn` scope), its feed-forward is not."""
    video = jnp.zeros((2, worker.CLIPS, 3, 1, 32, 32), jnp.float32)
    want = _jax_sharded_names(_jflagship(), video, 2)
    shards, _ = plan_shards(worker.flagship(), 2)
    assert set(shards) == want
    assert any("self_attn.in_proj_weight" in n for n in want)
    assert not any("linear1" in n for n in want)


def test_undivided_heads_stay_replicated_and_the_fused_kernel_refuses():
    """3 heads over 2 ranks: the attention stays whole (JAX's rule for a
    dimension that does not divide) while the MLPs shard; an attention on
    the fused kernel (use_kernel=True) refuses at shard time, naming its
    local head count."""
    from avt_tpu_torch.models import ViT

    vit = ViT(img_size=32, patch_size=16, embed_dim=96, depth=1, num_heads=3)
    shards, _ = plan_shards(vit, 2)
    assert set(shards) == {"blocks.0.mlp.fc1.weight", "blocks.0.mlp.fc2.weight"}
    vit = ViT(img_size=32, patch_size=16, embed_dim=384, depth=1, num_heads=6)
    vit.blocks[0].attn.use_kernel = True
    with pytest.raises(ValueError, match="leaves 3 heads of 6"):
        shard_model(vit, Mesh(1, 2, 0, 0))


# ------------------------------------------------------------ the launcher
DIM = 32
COMMON = ["model.backbone_dim=32", "model.future_predictor.n_layer=2",
          "model.future_predictor.inter_dim=32", "model.future_predictor.n_head=2",
          "data_train.workers=0", "data_eval.workers=0", "train.batch_size=4",
          "eval.batch_size=4", "model.dropout=0.0", "+model.future_predictor.embd_pdrop=0.0",
          "+model.future_predictor.attn_pdrop=0.0", "+model.future_predictor.resid_pdrop=0.0"]
EXPT = str(ROOT / chip_smoke.EXPT_02)


def _ckpt(run_dir):
    return torch.load(Path(run_dir) / CKPT_NAME, map_location="cpu", weights_only=True)


def test_launch_trains_model_parallel_ranks_that_match_one_process(tmp_path, monkeypatch):
    """expts/02 through `launch --spawn 2 parallel.model_size=2` (one
    replica of 2 model ranks, 4 clips a step) and through `train_net.cli`
    in one process: the checkpoint rank 0 wrote (the one-process layout),
    the merged eval results (model rank 1 writes none: no duplicate rows);
    then a second epoch in one process resumed from each checkpoint."""
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    tree = chip_smoke.write_ek100_tree(str(tmp_path / "ek100"), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=12, dim=DIM, seed=4)
    tp_dir, one_dir = tmp_path / "tp", tmp_path / "one"
    extra = tree + COMMON + ["train.num_epochs=1"]
    rcs = launch.main(["-c", EXPT, "--spawn", "2", "--run-dir", str(tp_dir)] + extra
                      + ["parallel.model_size=2", "dist_backend=gloo"])
    assert rcs == [0, 0]
    train_net.cli(["--config-file", EXPT, "--run-dir", str(one_dir)] + extra)
    got, want = _ckpt(tp_dir), _ckpt(one_dir)
    assert got["epoch"] == want["epoch"] == 1.0
    assert set(got["model"]) == set(want["model"])
    for name, v in want["model"].items():
        _close(got["model"][name].numpy(), v.numpy(), f"checkpoint {name}")
    for name, v in want["optimizer"]["momentum"].items():
        _close(got["optimizer"]["momentum"][name].numpy(), v.numpy(), f"momentum {name}")
    assert sorted(os.listdir(tp_dir / RESULTS_SAVE_DIR)) == ["0"]
    res, ref = (read_results(str(d / RESULTS_SAVE_DIR)) for d in (tp_dir, one_dir))
    assert len(np.unique(res["idx"])) == len(res["idx"])
    np.testing.assert_array_equal(res["idx"], ref["idx"])
    _close(res["logits/action"], ref["logits/action"], "eval logits")
    # a second epoch in one process from each checkpoint
    extra2 = tree + COMMON + ["train.num_epochs=2"]
    for run_dir in (tp_dir, one_dir):
        train_net.cli(["--config-file", EXPT, "--run-dir", str(run_dir)] + extra2)
    got, want = _ckpt(tp_dir), _ckpt(one_dir)
    assert got["epoch"] == want["epoch"] == 2.0
    for name, v in want["model"].items():
        _close(got["model"][name].numpy(), v.numpy(), f"resumed {name}")
    assert not list(tp_dir.glob("run*.pid"))


def test_launch_refuses_a_model_size_that_does_not_divide(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    expt = tmp_path / "e.txt"
    expt.write_text("train.batch_size=4\nparallel.model_size=2\n")
    with mock.patch.object(launch, "_spawn_ranks") as spawn:
        with pytest.raises(ValueError, match="does not divide the 3 ranks"):
            launch.main(["-c", str(expt), "--spawn", "3"])
        with pytest.raises(ValueError, match="model_size=4 does not divide the 2"):
            launch.main(["-c", str(expt), "--spawn", "2", "parallel.model_size=4"])
    spawn.assert_not_called()
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        make_mesh(2)
