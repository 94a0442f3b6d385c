"""The port's optimizer and LR schedules (avt_tpu_torch/train/optim.py)
against avt_tpu's (optax 0.2.6 underneath) on the CPU: the schedules step
for step, and the SGD update on identical gradients, with and without the
bf16 momentum buffer, frozen groups, bias_bn_wd_scale and gradient clipping.
The optax side runs op by op (not jitted), so each bf16 product is rounded
as the port rounds it."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from avt_tpu.train import optim as joptim
from avt_tpu_torch.train import optim as toptim

SCHEDULES = [
    pytest.param("cosine", dict(warmup_epochs=3, warmup_init_lr_ratio=0.1, eta_min=1e-3,
                                world_size=2), id="cosine-warmup-eta"),
    pytest.param("cosine", dict(warmup_epochs=2), id="cosine-warmup0"),
    pytest.param("cosine", dict(), id="cosine-nowarmup"),
    pytest.param("warmup_multi_step", dict(milestone_epochs=[4, 8], gamma=0.5,
                                           scheduler_warmup_epochs=2), id="multistep"),
    pytest.param("warmup_multi_step", dict(milestone_epochs=[3], warmup_method="constant",
                                           scheduler_warmup_epochs=1, warmup_epochs=2),
                 id="multistep-constant"),
    pytest.param("constant", dict(warmup_epochs=1, warmup_init_lr_ratio=0.5), id="constant"),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_matches_jax(name, kw):
    common = dict(iters_per_epoch=4, num_epochs=10)
    ref = joptim.build_schedule(name, 0.3, **common, **kw)
    out = toptim.build_schedule(name, 0.3, **common, **kw)
    for it in range(61):  # across the warmup boundary and past T_max
        # JAX evaluates in f32, the port in Python floats
        assert out(it) == pytest.approx(float(ref(it)), rel=2e-5, abs=1e-9), it


def test_plateau_and_other_optimizers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toptim.build_schedule("reduce_lr_on_plateau", 0.1, iters_per_epoch=1, num_epochs=1)
    for name in ("adam", "adamw", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            toptim.build_optimizer(nn.Linear(2, 2), [["__all__", 0.1, 0.0]], optimizer_name=name,
                                   iters_per_epoch=1, num_epochs=1)


class _Net(nn.Module):
    """Parameters named like the flax tree below: `fc` (weight + bias),
    `LayerNorm_0` (a norm: its weight is flax's `scale`), `head` (frozen)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(6, 5)
        self.LayerNorm_0 = nn.LayerNorm(5)
        self.head = nn.Linear(5, 3)


def _flax_name(torch_name):
    mod, leaf = torch_name.split(".")
    return mod, ("scale" if mod == "LayerNorm_0" and leaf == "weight" else leaf)


def _to_jax_tree(named):
    tree = {}
    for name, x in named.items():
        mod, leaf = _flax_name(name)
        tree.setdefault(mod, {})[leaf] = jnp.array(x, copy=True)  # no alias of torch's memory
    return tree


def _from_jax_tree(tree, names):
    return {n: np.asarray(tree[_flax_name(n)[0]][_flax_name(n)[1]], np.float32) for n in names}


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_sgd_matches_optax(momentum_dtype, nesterov, clip):
    torch.manual_seed(0)
    net = _Net()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    names = [n for n, _ in net.named_parameters()]
    kw = dict(lr_wd=[["head", 0.0, 0.0], ["__all__", 0.2, 1e-2]], optimizer_name="sgd",
              scheduler_name="cosine", iters_per_epoch=2, num_epochs=4, warmup_epochs=1,
              warmup_init_lr_ratio=0.25, bias_bn_wd_scale=0.5, grad_clip_max_norm=clip,
              optimizer_kwargs={"momentum": 0.9, "nesterov": nesterov,
                                "momentum_dtype": momentum_dtype})
    opt, _ = toptim.build_optimizer(net, **kw)
    assert opt.frozen == ["head.weight", "head.bias"]
    assert {tuple(g.names): g.weight_decay for g in opt.groups} == {
        ("fc.weight",): 1e-2, ("fc.bias", "LayerNorm_0.weight", "LayerNorm_0.bias"): 5e-3}
    params = _to_jax_tree({n: p.detach().numpy() for n, p in net.named_parameters()})
    tx, _ = joptim.build_optimizer(params, **kw)
    state = tx.init(params)
    head0 = net.head.weight.detach().clone()
    for step in range(5):
        # large grads so that the clip acts; the frozen head's are the largest
        grads = {n: (3.0 if n.startswith("head") else 1.0)
                 * rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in net.named_parameters()}
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        updates, state = tx.update(_to_jax_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
        ref = _from_jax_tree(params, names)
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {n}")
    assert opt.count == 5
    assert torch.equal(net.head.weight, head0)
    if momentum_dtype is not None:
        assert all(b.dtype == torch.bfloat16 for b in opt.momentum_buffers.values())


def test_lr_is_zero_at_the_first_step_under_warmup():
    net = _Net()
    opt, scheds = toptim.build_optimizer(net, [["__all__", 0.1, 0.0]], iters_per_epoch=3,
                                         num_epochs=5, warmup_epochs=2)
    before = [p.detach().clone() for p in net.parameters()]
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    assert all(s(0) == 0.0 and s(1) > 0 for s in scheds.values())
    opt.step()
    assert not torch.equal(before[0], net.fc.weight)


def test_state_dict_round_trip_and_missing_momentum():
    net = _Net()
    opt, _ = toptim.build_optimizer(net, [["fc", 0.1, 0.0]], iters_per_epoch=1, num_epochs=2,
                                    optimizer_kwargs={"momentum_dtype": "bf16"})
    assert set(opt.momentum_buffers) == {"fc.weight", "fc.bias"}  # the rest is unmatched
    state = {"count": 3, "momentum": {n: torch.full_like(b, 0.1, dtype=torch.float32)
                                      for n, b in opt.momentum_buffers.items()}}
    opt.load_state_dict(state)
    assert opt.count == 3
    assert opt.momentum_buffers["fc.bias"].dtype == torch.bfloat16
    assert opt.momentum_buffers["fc.bias"][0].item() == pytest.approx(0.1, rel=2 ** -8)
    del state["momentum"]["fc.bias"]
    with pytest.raises(KeyError, match="fc.bias"):
        opt.load_state_dict(state)
