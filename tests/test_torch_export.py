"""The port's serving export (avt_tpu_torch/serve.py: `export_eval_forward`,
`save_exported`, `load_exported`, `serving_fn`, `batch_predict` on an
artifact) against avt_tpu's `jax.export` forward on the CPU, and the attention
kernels' `torch.library` custom ops (avt_tpu_torch/ops/flash_attention.py)
under `torch.library.opcheck`: schema, fake implementation, autograd
registration and AOT dispatch, on their CPU route."""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu import serve as jserve
from avt_tpu.data import transforms as jtf
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    LinearClassifier as JLinearClassifier,
    ViT as JViT,
)
from avt_tpu_torch import serve
from avt_tpu_torch.data import transforms as ttf
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier, ViT
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import attention as tattn
from avt_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
PP_KW = dict(crop_size=32, scale_h=36, scale_w=-1, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
             eval_num_crops=3, eval_flip_crops=True)
DIM, N_CLS, T, H, W = 64, 8, 2, 40, 54
OUTPUTS = ("logits/action", "past_logits/action")
# f32 on both sides; the programs sum in another order than XLA's
TOL = 2e-4


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, T, H, W, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def tiny():
    """The same weights in avt_tpu's and the port's tiny ViT + AVT-h model
    (`convert.load_jax_params`), with their preprocessors."""
    jmodel = JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2),
        temporal_aggregator=JIdentityAgg(in_features=DIM),
        future_predictor=JAVTh(in_features=DIM, inter_dim=DIM, n_layer=2, n_head=2,
                               output_len=1, avg_last_n=1, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none")),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=DIM),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True,
    )
    tmodel = AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, inter_dim=DIM, n_layer=2, n_head=2,
                              output_len=1, avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none")),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True,
    )
    jpp = jtf.VideoPreprocessor(**PP_KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jpp.eval_fn(jnp.asarray(_frames(1)))[:, None])
    tmodel = load_jax_params(tmodel, params).eval()
    return jmodel, jpp, params, tmodel, ttf.VideoPreprocessor(**PP_KW, device="cpu")


@pytest.mark.parametrize("preproc", [True, False])
@pytest.mark.parametrize("bake", [True, False])
def test_exported_forward_matches_avt_tpu(tiny, bake, preproc):
    jmodel, jpp, params, tmodel, tpp = tiny
    frames = _frames(3, seed=2)
    if preproc:
        inp, shape = frames, frames.shape
    else:  # the preprocessed (B, 1, #crops, C, T, crop, crop) video
        inp = np.asarray(tpp.eval_fn(frames)[:, None])
        shape = inp.shape
    jprog = jserve.export_eval_forward(jmodel, params, shape, preprocessor=jpp if preproc else None,
                                       outputs=OUTPUTS, platforms=("cpu",), bake_params=bake)
    ref = jprog.call(jnp.asarray(inp)) if bake else jprog.call(params, jnp.asarray(inp))
    prog = serve.export_eval_forward(tmodel, shape, preprocessor=tpp if preproc else None,
                                     outputs=OUTPUTS, platforms=("cpu",), bake_params=bake)
    n_inputs = len(prog.graph_signature.user_inputs)
    assert (n_inputs == 1) == bake
    call = serve.serving_fn(prog)
    out = call(inp) if bake else call(serve.model_params(tmodel), inp)
    assert set(out) == set(ref) == set(OUTPUTS)
    for k in OUTPUTS:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL)


def test_export_refuses_another_platform_and_keeps_the_mode(tiny):
    *_, tmodel, tpp = tiny
    with pytest.raises(ValueError, match="one"):
        serve.export_eval_forward(tmodel, (2, T, H, W, 3), preprocessor=tpp, platforms=("cuda",))
    with pytest.raises(ValueError, match="one"):
        serve.export_eval_forward(tmodel, (2, T, H, W, 3), preprocessor=tpp,
                                  platforms=("cpu", "cuda"))
    tmodel.train()
    try:
        serve.export_eval_forward(tmodel, (2, T, H, W, 3), preprocessor=tpp)
        assert tmodel.training
    finally:
        tmodel.eval()


def _kernel_routed():
    """ops.attention with the packed kernel taken on the CPU too (its plain
    version there), so that the program names the custom op."""
    return mock.patch.object(tattn, "packed_attention",
                             functools.partial(tattn.packed_attention, use_kernel=True))


LOAD_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from avt_tpu_torch.serve import load_exported, batch_predict
    from avt_tpu_torch.ops import _build
    assert "avt_tpu_torch.models" not in sys.modules and "avt_tpu_torch.config" not in sys.modules
    prog = load_exported(sys.argv[1])
    frames = np.load(sys.argv[2])
    res = batch_predict(prog, frames)
    assert "avt_tpu_torch.models" not in sys.modules and "avt_tpu_torch.config" not in sys.modules
    assert not any(m == "jax" or m.startswith("avt_tpu.") for m in sys.modules)
    np.savez(sys.argv[3], **{k.replace("/", "|"): v for k, v in res.items()})
    print(sum(_build.launch_counts.values()))
""")


def test_save_load_round_trip_in_a_fresh_process(tiny, tmp_path):
    """The program names the packed attention op; a process that imports
    only avt_tpu_torch.ops (through serve) loads and runs it, no kernel
    launched on the CPU."""
    *_, tmodel, tpp = tiny
    frames = _frames(2, seed=5)
    with _kernel_routed():
        prog = serve.export_eval_forward(tmodel, frames.shape, preprocessor=tpp,
                                         outputs=OUTPUTS)
        want = serve.make_eval_forward(tmodel, tpp, OUTPUTS)(frames)
    targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
    assert "avt_tpu_torch.packed_short_attention.default" in targets
    path = tmp_path / "tiny.pt2"
    serve.save_exported(prog, str(path))
    np.save(tmp_path / "frames.npy", frames)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", LOAD_SCRIPT, str(path),
                           str(tmp_path / "frames.npy"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "0"
    got = np.load(tmp_path / "out.npz")
    for k in OUTPUTS:
        # the same program; the loaded one runs it in another process
        np.testing.assert_allclose(got[k.replace("/", "|")], want[k].numpy(), atol=1e-6, rtol=1e-6)


def test_batch_predict_on_an_artifact(tiny):
    *_, tmodel, tpp = tiny
    prog = serve.export_eval_forward(tmodel, (2, T, H, W, 3), preprocessor=tpp, outputs=OUTPUTS)
    frames = _frames(5, seed=3)
    res = serve.batch_predict(prog, frames)  # the batch size is the program's, 2
    whole = serve.make_eval_forward(tmodel, tpp, OUTPUTS)(frames)
    assert res["logits/action"].shape == (5, N_CLS)
    assert res["past_logits/action"].shape == (5, 2, N_CLS)
    for k in OUTPUTS:
        np.testing.assert_allclose(res[k], whole[k].numpy(), atol=1e-5, rtol=1e-5)
    same = serve.batch_predict(prog, frames, batch_size=2)
    np.testing.assert_array_equal(same["logits/action"], res["logits/action"])
    kept = serve.serving_fn(prog)  # what a server keeps: its batch size is the program's
    np.testing.assert_array_equal(serve.batch_predict(kept, frames)["logits/action"],
                                  res["logits/action"])
    assert serve.batch_predict(kept, frames[:0])["logits/action"].shape == (0, N_CLS)
    empty = serve.batch_predict(prog, frames[:0])
    assert empty["logits/action"].shape == (0, N_CLS)
    assert empty["past_logits/action"].shape == (0, 2, N_CLS)
    assert empty["logits/action"].dtype == np.float32
    with pytest.raises(ValueError, match="compiled for batch 2, got 4"):
        serve.batch_predict(prog, frames, batch_size=4)
    unbaked = serve.export_eval_forward(tmodel, (2, T, H, W, 3), preprocessor=tpp,
                                        bake_params=False)
    with pytest.raises(ValueError, match="params-baked"):
        serve.batch_predict(unbaked, frames)
    with pytest.raises(ValueError, match="batch_size"):
        serve.batch_predict(serve.make_eval_forward(tmodel, tpp), frames)


def _t(rng, *shape, grad=False):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(grad)


def _opcheck_cases():
    rng = np.random.default_rng(0)
    N, Tq, nh, D = 2, 9, 2, 32
    C = nh * D
    qkv, bias, dout = _t(rng, N, Tq, 3 * C, grad=True), _t(rng, 3 * C, grad=True), _t(rng, N, Tq, C)
    x, w, b = _t(rng, N, Tq, 128, grad=True), _t(rng, 128, 384, grad=True), _t(rng, 384, grad=True)
    q, k, v = (_t(rng, 2, 130, 2, 64, grad=True) for _ in range(3))
    out, lse = tfa._flash_op(q.detach(), k.detach(), v.detach(), True, True)
    return {
        "packed": (tfa._packed_op, (qkv, None, nh, True)),
        "packed_bias": (tfa._packed_op, (qkv, bias, nh, False)),
        "packed_bwd": (tfa._packed_bwd_op, (qkv.detach(), None, dout, nh, True)),
        "packed_bwd_db": (tfa._packed_bwd_op, (qkv.detach(), bias.detach(), dout, nh, False)),
        "fused": (tfa._fused_op, (x, w, b, 2, False)),
        "flash_lse": (tfa._flash_op, (q, k, v, True, True)),
        "flash": (tfa._flash_op, (q.detach(), k.detach(), v.detach(), False, False)),
        "flash_bwd": (tfa._flash_bwd_op, (q.detach(), k.detach(), v.detach(),
                                          _t(rng, 2, 130, 2, 64), out, lse.contiguous(), True)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_custom_op_passes_opcheck(case):
    op, args = _opcheck_cases()[case]
    _build.reset_launch_counts()
    torch.library.opcheck(op, args)
    assert sum(_build.launch_counts.values()) == 0  # the plain versions on the CPU


def test_ops_keep_the_plain_versions_bits_and_gradients():
    """Each public entry point returns its plain version's bits on the CPU,
    and its autograd returns the backward plain version's."""
    rng = np.random.default_rng(1)
    qkv, bias = _t(rng, 2, 70, 3 * 64, grad=True), _t(rng, 3 * 64, grad=True)
    dout = _t(rng, 2, 70, 64)
    out = tfa.packed_qkv_bias_attention(qkv, bias, 1)
    assert torch.equal(out, tfa.packed_short_attention_reference(qkv + bias, 1))
    out.backward(dout)
    dqkv, db = tfa.packed_short_attention_bwd_reference((qkv + bias).detach(), dout, 1,
                                                        with_db=True)
    assert torch.equal(qkv.grad, dqkv) and torch.equal(bias.grad, db)
    q, k, v = (_t(rng, 1, 130, 1, 64, grad=True) for _ in range(3))
    do = _t(rng, 1, 130, 1, 64)
    o = tfa.flash_attention(q, k, v, causal=True)
    ref, lse = tfa.flash_attention_reference(q.detach(), k.detach(), v.detach(), True)
    assert torch.equal(o, ref)
    o.backward(do)
    grads = tfa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), do, ref, lse,
                                              True)
    assert all(torch.equal(a.grad, g) for a, g in zip((q, k, v), grads))
    with torch.no_grad():  # no logsumexp written when autograd will not need it
        assert torch.equal(tfa.flash_attention(q, k, v, causal=True), ref)


def test_export_tool_writes_a_program_from_a_config(tmp_path, monkeypatch):
    """tools/torch_export_model.py on expts/02 at a small width (a synthetic
    EK100 tree for its classes), 10 features a clip in, exported for the
    CPU: the .pt2 loads and answers a batch."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    import torch_export_model

    tree = chip_smoke.write_ek100_tree(str(tmp_path / "tree"), train_videos=1, eval_videos=1,
                                       actions_per_video=2, first_action_s=12, dim=32, seed=1)
    out = tmp_path / "f.pt2"
    torch_export_model.main(["model.backbone_dim=32", "model.future_predictor.n_layer=1",
                             "model.future_predictor.inter_dim=32",
                             "model.future_predictor.n_head=2"] + tree
                            + ["-c", str(ROOT / chip_smoke.EXPT_02), "--platforms", "cpu",
                               "-o", str(out), "-B", "2", "-T", "10", "--no-preproc",
                               "--feat-dim", "32"])
    prog = serve.load_exported(str(out))
    video = np.random.default_rng(0).standard_normal((3, 10, 32, 1, 1, 1)).astype(np.float32)
    res = serve.batch_predict(prog, video)
    assert res["logits/action"].shape == (3, chip_smoke.NUM_ACTIONS)
    assert np.isfinite(res["logits/action"]).all()
