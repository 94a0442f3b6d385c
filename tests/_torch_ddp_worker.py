"""One rank of tests/test_torch_ddp.py's two-process run, and the checks it
runs, which the test also runs in one process on the global batch.

Run as:  python tests/_torch_ddp_worker.py <inputs.npz> <out_dir>
with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set: the rank joins a
gloo process group through `avt_tpu_torch.parallel.setup_distributed`, takes
its rows of every global input (rank r of R: rows [r*n/R, (r+1)*n/R)) and
writes what `run_checks` returns to <out_dir>/rank<r>.npz.
"""
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avt_tpu_torch.losses import mse  # noqa: E402
from avt_tpu_torch.losses.infonce import SimclrInfoNCE  # noqa: E402
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier  # noqa: E402
from avt_tpu_torch.models.backbones import IdentityBackbone  # noqa: E402
from avt_tpu_torch.models.norm import batch_norm  # noqa: E402
from avt_tpu_torch.parallel import ddp  # noqa: E402
from avt_tpu_torch.train import MetricLogger, build_optimizer, make_train_step  # noqa: E402
from avt_tpu_torch.train.step import step_generator  # noqa: E402

FEAT, N_CLS, T = 16, 10, 6
AVTH = dict(inter_dim=32, n_layer=2, n_head=2)
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
OPT = dict(lr_wd=[["__all__", 0.1, 1e-6]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=4, num_epochs=3, optimizer_kwargs={"nesterov": True})
SEED = 5


def feature_model(pdrop: float, output_len: int):
    """The feature path's AVT-h model at a small width; with output_len > 1
    and pdrop > 0, train-mode dropout is position-stable (a rollout)."""
    torch.manual_seed(0)
    return AVTModel(
        backbone=IdentityBackbone(),
        temporal_aggregator=IdentityAgg(in_features=FEAT),
        future_predictor=AVTh(in_features=FEAT, output_len=output_len, avg_last_n=1,
                              return_past_too=True, embd_pdrop=pdrop, attn_pdrop=pdrop,
                              resid_pdrop=pdrop,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=FEAT),
        classifiers={"action": LinearClassifier(FEAT, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=FEAT, dropout=0.0,
        classifier_on_past=True)


def torch_batch(inputs, j, rows=lambda x: x):
    return {"video": torch.from_numpy(rows(inputs[f"video{j}"])),
            "target": {"action": torch.from_numpy(rows(inputs[f"target{j}"]))},
            "target_subclips": {"action": torch.from_numpy(rows(inputs[f"tsub{j}"]))}}


def run_checks(inputs) -> dict:
    """This process's share of every check, as numpy arrays."""
    r, world = ddp.rank(), ddp.world_size()

    def rows(x):
        n = x.shape[0] // world
        return x[r * n:(r + 1) * n]

    out = {}
    # the step generators: each rank's own draws, and the shared ones
    out["draw_own"] = torch.rand(6, generator=step_generator(7, 3, "cpu")).numpy()
    shared = ddp.shared_generator(step_generator(7, 3, "cpu"))
    out["draw_shared"] = torch.rand(6, generator=shared).numpy()

    # BatchNorm over the global batch: two train steps of conv + BN
    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv3d(3, 4, 1), batch_norm(4, dims=3, eps=1e-3, mom=0.1))
    x, w = torch.from_numpy(rows(inputs["bn_x"])), torch.from_numpy(rows(inputs["bn_w"]))
    for i in range(2):
        net.zero_grad()
        y = net(x)
        (y * w).sum(dim=(1, 2, 3, 4)).mean().backward()
        ddp.allreduce_gradients(net.parameters())
        out[f"bn_y{i}"] = y.detach().numpy()
    bn = net[1]
    out.update(bn_running_mean=bn.running_mean.numpy(), bn_running_var=bn.running_var.numpy(),
               bn_tracked=bn.num_batches_tracked.numpy(), bn_dconv=net[0].weight.grad.numpy(),
               bn_dweight=bn.weight.grad.numpy(), bn_dbias=bn.bias.grad.numpy())

    # InfoNCE with the negatives of every rank, K = 2 positives an item
    nce_out = torch.from_numpy(rows(inputs["nce_out"])).requires_grad_(True)
    nce_tgt = torch.from_numpy(rows(inputs["nce_tgt"])).requires_grad_(True)
    loss = SimclrInfoNCE(temperature=0.1)(nce_out, nce_tgt)
    loss.backward()
    out.update(nce_loss=loss.detach().numpy(), nce_dout=nce_out.grad.numpy(),
               nce_dtgt=nce_tgt.grad.numpy())

    # two train steps with position-stable dropout live (a rollout of 2)
    model = feature_model(pdrop=0.1, output_len=2)
    opt, _ = build_optimizer(model, **OPT)
    step = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})
    for j in range(2):
        metrics = step(torch_batch(inputs, j, rows), step_generator(SEED, j, "cpu"))
        for k, v in metrics.items():
            out[f"step{j}/{k}"] = v.numpy()
    for name, p in model.named_parameters():
        out[f"param/{name}"] = p.detach().numpy()

    # the meters: rank r logs loss 1 + r once and acc 0.5 r over 2 + r clips
    meters = MetricLogger()
    meters.update(loss=1.0 + r)
    meters.update(n=2 + r, acc=0.5 * r)
    meters.synchronize_between_processes()
    out["meters"] = np.array([meters["loss"].global_avg, meters["acc"].global_avg,
                              meters["acc"].count])
    return out


def main() -> None:
    inputs_path, out_dir = sys.argv[1], sys.argv[2]
    if not ddp.setup_distributed("gloo", "cpu"):
        raise RuntimeError("run with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set")
    inputs = dict(np.load(inputs_path))
    out = run_checks(inputs)
    np.savez(os.path.join(out_dir, f"rank{ddp.rank()}.npz"), **out)
    ddp.cleanup()


if __name__ == "__main__":
    main()
