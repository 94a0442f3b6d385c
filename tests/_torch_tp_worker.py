"""One rank of tests/test_torch_tensor_parallel.py's spawned runs, and the
checks it runs, which the test also runs in one process.

Run as:  python tests/_torch_tp_worker.py <inputs.npz> <out_dir> <n_model>
with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set: the rank joins a
gloo process group, builds the (world / n_model, n_model) mesh, shards the
models, takes its data replica's rows of every global input (replica d of
R: rows [d*n/R, (d+1)*n/R)) and writes what `run_checks` returns, every
tensor in the one-process layout, to <out_dir>/rank<r>.npz.

The checks: two SGD steps and one Adafactor step with gradient clipping on
`jax_model` (dropout 0), which the test holds against the JAX package's
tensor-parallel mesh; two SGD steps of `flagship` (a Transformer
aggregator, every dropout live, a rollout of 2 with position-stable masks)
and its eval outputs and attention maps, recompute and KV cache, which the
test holds against one process; the state round trip through
`shard_state_dict` and `gather_state_dict`; a one-process checkpoint
resumed by the sharded model.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avt_tpu_torch.losses import mse  # noqa: E402
from avt_tpu_torch.models import (  # noqa: E402
    AVTh,
    AVTModel,
    IdentityAgg,
    LinearClassifier,
    TransformerAgg,
    ViT,
)
from avt_tpu_torch.models.layers import init_normal_  # noqa: E402
from avt_tpu_torch.parallel import ddp  # noqa: E402
from avt_tpu_torch.parallel.mesh import (  # noqa: E402
    current_mesh,
    gather_state_dict,
    make_mesh,
    shard_model,
    shard_state_dict,
)
from avt_tpu_torch.train import build_optimizer, make_train_step  # noqa: E402
from avt_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from avt_tpu_torch.train.step import step_generator  # noqa: E402

DIM, HEADS, N_CLS, B, CLIPS = 128, 4, 10, 4, 4
AVTH = dict(inter_dim=64, n_layer=2, n_head=4)
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
SGD = dict(lr_wd=[["__all__", 0.1, 1e-4]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=4, num_epochs=3, warmup_epochs=1, grad_clip_max_norm=1.0,
           optimizer_kwargs={"nesterov": True})
ADAFACTOR = dict(lr_wd=[["__all__", 0.1, 1e-4]], optimizer_name="adafactor",
                 scheduler_name="cosine", iters_per_epoch=4, num_epochs=3,
                 grad_clip_max_norm=1.0)
SEED = 7


def jax_model():
    """A small flagship of 4 heads a layer (ViT-B/16's layout at width 128,
    2 blocks; AVT-h of 2 layers) with every dropout 0: the model the test
    also builds in the JAX package."""
    return AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=HEADS),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, output_len=1, avg_last_n=1, return_past_too=True,
                              embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True)


def flagship(pdrop: float = 0.1):
    """The small flagship with a Transformer aggregator after AVT-h and every
    dropout at pdrop: the ViT's (replicated), AVT-h's (a rollout of 2: its
    masks position-stable, keyed by global channel), the encoder's (inside
    its sharded attention: full-width draws, sliced) and the classifier's.
    Weights N(0, 0.02) from a seeded generator, so that every process builds
    the same model."""
    model = AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=HEADS,
                     drop_rate=pdrop),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, output_len=2, return_past_too=True,
                              embd_pdrop=pdrop, attn_pdrop=pdrop, resid_pdrop=pdrop,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=TransformerAgg(
            in_features=DIM, inter_rep=64, nheads=HEADS, nlayers=1, ffn_dim=128, dropout=pdrop),
        classifiers={"action": LinearClassifier(64, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=pdrop)
    gen = torch.Generator().manual_seed(0)
    init_normal_(model, 0.02, gen)
    conv = model.backbone["model"].patch_embed.proj  # the one layer init_normal_ leaves
    torch.nn.init.normal_(conv.weight, std=0.02, generator=gen)
    torch.nn.init.zeros_(conv.bias)
    return model


def batch(inputs, j, rows=lambda x: x):
    return {"video": torch.from_numpy(rows(inputs[f"video{j}"])),
            "target": {"action": torch.from_numpy(rows(inputs[f"target{j}"]))},
            "target_subclips": {"action": torch.from_numpy(rows(inputs[f"tsub{j}"]))}}


def _loaded(model, inputs, prefix):
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items()
          if k.startswith(prefix)}
    if sd:
        model.load_state_dict(sd)
    return model


def _equal_states(a, b) -> bool:
    """Two state_dicts (model, or optimizer: {kind: {name: tensor}}) equal
    bit for bit."""
    if set(a) != set(b):
        return False
    for k, v in a.items():
        if isinstance(v, dict):
            if not _equal_states(v, b[k]):
                return False
        elif isinstance(v, torch.Tensor):
            if not (v.shape == b[k].shape and torch.equal(v, b[k])):
                return False
        elif v != b[k]:
            return False
    return True


def _record(out, prefix, model, opt=None):
    """The model's parameters, and the optimizer's buffers, gathered."""
    for name, v in gather_state_dict(model.state_dict(), model).items():
        out[f"{prefix}/param/{name}"] = v.numpy().copy()
    if opt is not None:
        for kind, bufs in gather_state_dict(opt.state_dict(), model).items():
            if isinstance(bufs, dict):
                for name, v in bufs.items():
                    if isinstance(v, torch.Tensor):
                        out[f"{prefix}/{kind}/{name}"] = v.numpy().copy()


def _train(out, prefix, model, opt_kw, inputs, steps, rows, generators=False):
    opt, _ = build_optimizer(model, **opt_kw)
    step = make_train_step(model, opt, LOSS_WTS if prefix != "live" else
                           {"cls_action": 1.0, "feat": 1.0}, {"action": N_CLS})
    for j in range(steps):
        gen = step_generator(SEED, j, "cpu") if generators else None
        for key, v in step(batch(inputs, j, rows), gen).items():
            out[f"{prefix}/step{j}/{key}"] = v.numpy()
    _record(out, prefix, model, opt)
    return opt


def run_checks(inputs, n_model: int = 1, save_dir=None, resume_dir=None) -> dict:
    """This process's share of every check, as numpy arrays (sharded
    tensors gathered); in one process, the one-process values. save_dir:
    where the SGD run's checkpoint is written (epoch 2.0); resume_dir: a
    checkpoint of that run that the sharded model resumes."""
    mesh = make_mesh(n_model)
    n = B // mesh.n_data
    lo = mesh.data_rank * n

    def rows(x):
        return x[lo:lo + n]

    out = {}
    # against the JAX package's mesh: SGD with clipping, then Adafactor
    model = _loaded(jax_model(), inputs, "init/")
    shards = shard_model(model, mesh)
    out["sharded"] = np.array(sorted(shards) or [""])
    opt = _train(out, "sgd", model, SGD, inputs, 2, rows)
    if save_dir is not None:
        save_checkpoint(save_dir, model, opt, 2.0)
    model = _loaded(jax_model(), inputs, "init/")
    shard_model(model, mesh)
    opt = _train(out, "adafactor", model, ADAFACTOR, inputs, 1, rows)
    # the round trip: gathered, cut again and gathered once more, bit for bit
    for what, state in (("model", model.state_dict()), ("optimizer", opt.state_dict())):
        full = gather_state_dict(state, model)
        local = shard_state_dict(full, model)
        out[f"roundtrip/{what}"] = np.array(
            _equal_states(local, state) and _equal_states(gather_state_dict(local, model), full))
    if resume_dir is not None:
        model = _loaded(jax_model(), inputs, "init/")
        shard_model(model, mesh)
        opt, _ = build_optimizer(model, **SGD)
        out["resumed/epoch"] = np.array(restore_checkpoint(resume_dir, model, opt))
        _record(out, "resumed", model, opt)
    # against one process: every dropout live, the same draws
    model = flagship()
    shard_model(model, mesh)
    _train(out, "live", model, SGD, inputs, 2, rows, generators=True)
    model.eval()
    video = torch.from_numpy(rows(inputs["video0"]))
    with torch.no_grad():
        model.future_predictor.output_attentions = True
        outputs, _ = model(video, (n,))
        for key in ("logits/action", "gpt2_att_0", "gpt2_att_1"):
            out[f"eval/{key}"] = outputs[key].numpy()
        model.future_predictor.output_attentions = False
        model.future_predictor.rollout_mode = "cache"
        out["eval_cache/logits/action"] = model(video, (n,))[0]["logits/action"].numpy()
    out["mesh"] = np.array([mesh.n_data, mesh.n_model, mesh.data_rank, mesh.model_rank])
    return out


if __name__ == "__main__":
    inputs_path, out_dir, n_model = sys.argv[1], sys.argv[2], int(sys.argv[3])
    ddp.setup_distributed("gloo", "cpu")
    torch.manual_seed(0)
    res = run_checks(dict(np.load(inputs_path)), n_model,
                     save_dir=os.path.join(out_dir, f"ckpt_tp{n_model}"),
                     resume_dir=os.path.join(out_dir, "ckpt_one"))
    assert current_mesh().n_model == n_model
    np.savez(os.path.join(out_dir, f"rank{ddp.rank()}.npz"), **res)
    ddp.cleanup()
