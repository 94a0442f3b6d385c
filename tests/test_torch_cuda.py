"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so the file runs on a GPU host:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import flash_attention as tfa

# bf16: p and the output are rounded to bf16 (2^-8 relative), and the kernel
# forms p against a running max where the plain version uses the final one;
# f32: the same math summed in another order.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(N, T, H, D, dtype, device, seed=0):
    x = np.random.default_rng(seed).standard_normal((N, T, 3 * H * D)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _f32_grid(existing):
    """The f32 form on the bf16 form's grid (cases not already in `existing`):
    every sequence length at every head dim, causal and not, the bias on at
    odd T; one frame, an odd frame count (db) and more blocks than the card
    holds at T=197; and expts/01's eval batch of 180 frames."""
    grid = [("float32", D, T, causal, T % 2 == 1, 6)
            for D in (32, 64, 128) for T in (5, 17, 197, 300, 600) for causal in (False, True)]
    grid += [("float32", 64, 197, causal, True, N) for N in (1, 5, 64) for causal in (False, True)]
    grid += [("float32", 64, 197, False, True, 180)]
    return existing + [case for case in grid if case not in existing]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,T,causal,bias,N", _f32_grid([
    ("bfloat16", 64, 197, False, False, 6), ("bfloat16", 64, 197, False, True, 6),
    ("float32", 64, 197, False, True, 6), ("bfloat16", 32, 197, True, False, 6),
    ("bfloat16", 128, 197, True, True, 6), ("float32", 128, 197, False, False, 6),
    # several query tiles and key tiles per sequence; a sequence shorter than a tile
    ("bfloat16", 64, 600, True, True, 6), ("bfloat16", 64, 600, False, False, 6),
    ("float32", 32, 300, True, False, 6), ("bfloat16", 64, 5, False, True, 6),
    # one warp and a part of the next (17); two query blocks with a second key
    # tile (300), at every head dim; one frame; more blocks than the card holds
    ("bfloat16", 32, 17, False, True, 6), ("bfloat16", 64, 17, True, True, 6),
    ("bfloat16", 128, 17, False, False, 6), ("bfloat16", 32, 300, True, True, 6),
    ("bfloat16", 64, 300, False, True, 6), ("bfloat16", 128, 300, True, False, 6),
    ("bfloat16", 64, 197, True, True, 1), ("bfloat16", 64, 197, False, True, 64),
]))
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, D, T, causal, bias, N):
    H = 768 // D
    x = _qkv(N, T, H, D, dtype, cuda_device, seed=3)
    b = (torch.randn(3 * H * D, generator=torch.Generator().manual_seed(4)) if bias
         else torch.zeros(3 * H * D)).to(cuda_device)
    _build.reset_launch_counts()
    out = tfa.packed_qkv_bias_attention(x, b, H, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.KERNEL] == 1
    ref = tfa.packed_short_attention_reference(x + b.to(x.dtype), H, causal)
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(tfa.packed_qkv_bias_attention(x, b, H, causal), out)  # same bits


@pytest.mark.cuda
def test_cuda_kernel_raises_on_unbuilt_head_dim(cuda_device):
    x = torch.zeros(1, 70, 3 * 2 * 48, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.packed_short_attention(x, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.packed_short_attention(torch.zeros(1, 70, 2 * 3 * 64, dtype=torch.bfloat16,
                                               device=cuda_device)[:, ::2], 1)


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,T,causal,bias,N", _f32_grid([
    ("bfloat16", 64, 197, False, True, 6), ("float32", 64, 197, False, True, 6),
    ("bfloat16", 32, 197, False, False, 6), ("bfloat16", 32, 197, True, False, 6),
    ("bfloat16", 128, 197, False, False, 6), ("float32", 128, 197, True, True, 6),
    ("float32", 32, 197, True, False, 6),
    # several query and key tiles per sequence; a sequence shorter than a tile
    ("bfloat16", 64, 600, True, True, 6), ("bfloat16", 64, 600, False, False, 6),
    ("float32", 64, 600, True, True, 6), ("bfloat16", 64, 5, False, True, 6),
    ("float32", 32, 5, True, True, 6),
    # one warp and a part of the next (17); a second staged query or key tile
    # (300), at every head dim; db summed over an odd number of frames; one
    # frame; more blocks than the card holds
    ("bfloat16", 32, 17, True, True, 6), ("bfloat16", 64, 17, False, True, 6),
    ("bfloat16", 128, 17, True, False, 6), ("bfloat16", 32, 300, False, True, 6),
    ("bfloat16", 64, 300, True, True, 6), ("bfloat16", 128, 300, False, True, 6),
    ("bfloat16", 64, 197, False, True, 5), ("bfloat16", 64, 197, True, True, 1),
    ("bfloat16", 64, 197, False, True, 64),
]))
def test_cuda_backward_matches_plain_version(cuda_device, dtype, D, T, causal, bias, N):
    H = 768 // D
    x = _qkv(N, T, H, D, dtype, cuda_device, seed=5)
    do = _qkv(N, T, H, D, dtype, cuda_device, seed=6)[..., : H * D].contiguous()
    b = (torch.randn(3 * H * D, generator=torch.Generator().manual_seed(7)) if bias
         else torch.zeros(3 * H * D)).to(cuda_device, x.dtype)
    _build.reset_launch_counts()
    dqkv, db = tfa._launch_bwd(x, b, do, H, causal, with_db=True)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.BWD_KERNEL] == 1
    ref, ref_db = tfa.packed_short_attention_bwd_reference(x + b, do, H, causal, with_db=True)
    assert _rel_err(dqkv, ref) <= TOL[dtype]
    assert _rel_err(db, ref_db) <= TOL[dtype]
    again, db_again = tfa._launch_bwd(x, b, do, H, causal, with_db=True)
    assert torch.equal(again, dqkv) and torch.equal(db_again, db)  # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 32])
def test_cuda_grads_reach_qkv_and_bias(cuda_device, D):
    H = 768 // D
    x = _qkv(4, 197, H, D, "bfloat16", cuda_device, seed=8).requires_grad_(True)
    b = torch.randn(3 * H * D, device=cuda_device, requires_grad=True)
    _build.reset_launch_counts()
    out = tfa.packed_qkv_bias_attention(x, b, H)
    out.float().square().sum().backward()
    assert x.grad is not None and b.grad is not None and b.grad.dtype == torch.float32
    assert torch.isfinite(x.grad).all() and torch.isfinite(b.grad).all()
    y = x.detach().clone().requires_grad_(True)
    tfa.packed_short_attention(y, H, causal=True).float().sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{name: 0 for name in _build.KERNELS},
                                    tfa.KERNEL: 2, tfa.BWD_KERNEL: 2}


def _heads(B, T, H, D, dtype, device, seed):
    x = np.random.default_rng(seed).standard_normal((B, T, H, D)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,H,T,causal", [
    # AVT-h of expts/02 (4 heads of 512) and of expts/13 (8 of 256), TransformerAgg's 8 of 64
    ("float32", 512, 4, 256, True), ("bfloat16", 512, 4, 256, False),
    # the Transformer aggregator's encoder attention over 256 features: non-causal
    ("float32", 64, 8, 256, False), ("bfloat16", 64, 8, 256, False),
    ("float32", 256, 8, 256, False), ("bfloat16", 256, 8, 200, True),
    ("float32", 128, 2, 130, True), ("bfloat16", 128, 2, 300, False),
    ("float32", 64, 8, 200, True), ("bfloat16", 64, 8, 256, True),
    ("float32", 512, 1, 5, False),  # shorter than a tile
    # AVT-h of expts/04 (2 heads of 1024)
    ("float32", 1024, 2, 256, True), ("bfloat16", 1024, 2, 130, False),
    ("float32", 1024, 1, 5, False),
    # many key tiles of the dk/dv side's 32 (D=512) and 64 (D=256) keys
    ("float32", 512, 2, 300, True), ("bfloat16", 512, 2, 300, False),
    ("bfloat16", 256, 4, 333, False),
    # just under and just over a step's 16 rows and a block's 32 at D=512
    ("float32", 512, 2, 15, True), ("bfloat16", 512, 2, 15, False),
    ("float32", 512, 2, 17, False), ("bfloat16", 512, 2, 17, True),
    ("float32", 512, 2, 31, True), ("bfloat16", 512, 2, 31, False),
    ("float32", 512, 2, 33, False), ("bfloat16", 512, 2, 33, True),
    # and under and over a step's 8 rows and a block's 16 at D=1024
    ("float32", 1024, 2, 7, True), ("bfloat16", 1024, 2, 7, False),
    ("float32", 1024, 2, 9, False), ("bfloat16", 1024, 2, 9, True),
    ("float32", 1024, 2, 15, True), ("bfloat16", 1024, 2, 15, False),
    ("float32", 1024, 2, 17, False), ("bfloat16", 1024, 2, 17, True),
])
def test_cuda_flash_matches_plain_version(cuda_device, dtype, D, H, T, causal):
    q, k, v, do = (_heads(3, T, H, D, dtype, cuda_device, seed) for seed in range(4))
    _build.reset_launch_counts()
    out, lse = tfa._launch_flash(q, k, v, causal, want_lse=True)
    delta = tfa._delta(do, out)
    dq, dk, dv = tfa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FLASH_KERNEL] == 1
    assert _build.launch_counts[tfa.FLASH_BWD_KERNEL] == 1
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=TOL[dtype], rtol=TOL[dtype])
    refs = tfa.flash_attention_bwd_reference(q, k, v, do, out, lse, causal)
    for got, want in zip((dq, dk, dv), refs):
        assert _rel_err(got, want) <= TOL[dtype]
    again = tfa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))  # no atomics: same bits
    assert torch.equal(tfa._launch_flash(q, k, v, causal, want_lse=False)[0], out)


def _unequal_lengths(device, D, causal, Tq, Tk):
    q, do = (_heads(2, Tq, 2, D, "float32", device, seed) for seed in (11, 12))
    k, v = (_heads(2, Tk, 2, D, "float32", device, seed) for seed in (13, 14))
    out, lse = tfa._launch_flash(q, k, v, causal, want_lse=True)
    grads = tfa._launch_flash_bwd(q, k, v, do, lse, tfa._delta(do, out), causal)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=TOL["float32"])
    torch.testing.assert_close(lse, ref_lse, atol=TOL["float32"], rtol=TOL["float32"])
    refs = tfa.flash_attention_bwd_reference(q, k, v, do, out, lse, causal)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    for got, want in zip(grads, refs):
        assert _rel_err(got, want) <= TOL["float32"]


@pytest.mark.cuda
def test_cuda_transformer_agg_runs_the_flash_kernels_non_causal(cuda_device):
    """The Transformer aggregator at its defaults (6 layers of 8 heads of 64)
    over 256 features: one flash forward a layer and one backward, and the
    output and gradients of the plain path (use_kernel=False)."""
    from unittest import mock

    import avt_tpu_torch.models.layers as tlayers
    from avt_tpu_torch.models import TransformerAgg
    from avt_tpu_torch.models.flagship import init_aggregator

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    agg = TransformerAgg(1024, device=cuda_device).train()
    with torch.no_grad():
        init_aggregator(agg, gen)
    x = torch.randn(4, 256, 1024, device=cuda_device, generator=gen)
    plain = tlayers.dot_product_attention

    def run(use_kernel):
        agg.zero_grad()
        g = torch.Generator(device=cuda_device).manual_seed(1)  # the same dropout masks
        with mock.patch.object(tlayers, "dot_product_attention",
                               lambda *a, **k: plain(*a, **k, use_kernel=use_kernel)):
            out, _ = agg(x, g)
            out.square().sum().backward()
        return out.detach(), {n: p.grad.clone() for n, p in agg.named_parameters()}

    _build.reset_launch_counts()
    out, grads = run(None)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.KERNELS},
                                    tfa.FLASH_KERNEL: 6, tfa.FLASH_BWD_KERNEL: 6}
    ref, ref_grads = run(False)
    assert _rel_err(out, ref) <= TOL["float32"]
    for name, g in grads.items():
        assert _rel_err(g, ref_grads[name]) <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_with_more_keys_than_queries(cuda_device, causal):
    _unequal_lengths(cuda_device, 128, causal, 150, 260)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_with_more_keys_than_queries_at_head_dim_1024(cuda_device, causal):
    _unequal_lengths(cuda_device, 1024, causal, 150, 260)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 512, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_with_more_queries_than_keys(cuda_device, D, causal):
    """The query-major kernels bound a causal block's keys by its last query:
    here queries past the last key, and query blocks that end past it."""
    _unequal_lengths(cuda_device, D, causal, 260, 150)


@pytest.mark.cuda
def test_cuda_flash_reads_packed_views_in_place(cuda_device):
    B, T, H, D = 2, 150, 4, 128
    qkv = _qkv(B, T, H, D, "float32", cuda_device, seed=9).requires_grad_(True)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    _build.reset_launch_counts()
    out = tfa.flash_attention(q, k, v, causal=True)
    (grad,) = torch.autograd.grad(out.square().sum(), qkv)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FLASH_KERNEL] == 1
    assert _build.launch_counts[tfa.FLASH_BWD_KERNEL] == 1
    x = qkv.detach().requires_grad_(True)
    q2, k2, v2 = (t.reshape(B, T, H, D).contiguous() for t in x.split(H * D, dim=-1))
    ref = tfa.flash_attention_reference(q2, k2, v2, True)[0]
    (ref_grad,) = torch.autograd.grad(ref.square().sum(), x)
    torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=TOL["float32"])
    assert _rel_err(grad, ref_grad) <= TOL["float32"]


@pytest.mark.cuda
def test_cuda_flash_raises_on_unbuilt_head_dim(cuda_device):
    x = torch.zeros(1, 130, 2, 96, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.flash_attention(x, x, x)
    with pytest.raises(TypeError, match="storage type"):
        tfa.flash_attention(*(torch.zeros(1, 130, 2, 64, dtype=torch.float16,
                                          device=cuda_device),) * 3)


def _fused_inputs(N, T, H, dtype, device, seed):
    rng = np.random.default_rng(seed)
    C = 64 * H
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((N, T, C), (3 * C, C), (3 * C,)))
    tdt = getattr(torch, dtype)
    # w as the ViT passes it: the transposed view of a (3C, C) weight
    return (torch.from_numpy(x * 0.5).to(device, tdt), torch.from_numpy(w * 0.05).to(device, tdt).t(),
            torch.from_numpy(b * 0.1).to(device, tdt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,H,causal,N", [
    ("bfloat16", 197, 12, False, 3), ("float32", 197, 12, False, 3),
    ("bfloat16", 100, 4, True, 3), ("float32", 100, 4, True, 3),
    # several 256-row tiles per sequence; a sequence shorter than a warp's rows
    ("bfloat16", 300, 4, True, 3), ("bfloat16", 300, 4, False, 3),
    ("float32", 300, 2, True, 3), ("bfloat16", 5, 2, False, 3),
    # the bf16 form's tile edges: whole and one row into the next warpgroup of
    # 64 rows, one 256-row tile and one row into the second; both masks
    ("bfloat16", 64, 2, False, 3), ("bfloat16", 65, 2, True, 3),
    ("bfloat16", 128, 2, True, 3), ("bfloat16", 129, 2, False, 3),
    ("bfloat16", 256, 2, False, 3), ("bfloat16", 256, 2, True, 3),
    ("bfloat16", 257, 2, True, 3), ("bfloat16", 257, 2, False, 3),
    ("float32", 257, 2, False, 3), ("float32", 65, 2, True, 3),
    # one frame; two heads and twelve at the ViT's length
    ("bfloat16", 197, 12, True, 1), ("float32", 197, 2, False, 1),
    ("bfloat16", 197, 2, False, 5), ("bfloat16", 197, 12, True, 5),
])
def test_cuda_fused_kernel_matches_plain_version(cuda_device, dtype, T, H, causal, N):
    x, w, b = _fused_inputs(N, T, H, dtype, cuda_device, seed=T + H)
    _build.reset_launch_counts()
    out, qkv = tfa._launch_fused(x, w, b, H, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FUSED_KERNEL] == 1
    ref, ref_qkv = tfa.fused_qkv_attention_reference(x, w, b, H, causal)
    torch.testing.assert_close(qkv, ref_qkv, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    # the same bits on a repeat
    again, qkv_again = tfa._launch_fused(x, w, b, H, causal)
    assert torch.equal(again, out) and torch.equal(qkv_again, qkv)
    # a contiguous (C, 3C) w is copied into the kernel's layout: the same result
    out2, qkv2 = tfa._launch_fused(x, w.contiguous(), b, H, causal)
    assert torch.equal(out2, out) and torch.equal(qkv2, qkv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_fused_grads_match_plain_version(cuda_device, dtype):
    """The autograd Function on the card (the fused kernel, the no-db
    backward kernel, library products) against the same Function on the CPU
    (the plain versions); x in the storage type, w and b f32."""
    x, w, b = _fused_inputs(4, 197, 12, dtype, cuda_device, seed=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda_device, x.dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w.float(), b.float())]
    _build.reset_launch_counts()
    out = tfa.fused_qkv_attention(*leaves, 12)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FUSED_KERNEL] == 1
    assert _build.launch_counts[tfa.BWD_KERNEL] == 1
    assert _build.launch_counts[tfa.KERNEL] == 0
    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    ref = tfa.fused_qkv_attention(*cpu, 12)
    refs = torch.autograd.grad(ref, cpu, g.cpu())
    torch.testing.assert_close(out.cpu(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    for got, want in zip(grads, refs):
        assert got.dtype == want.dtype
        assert _rel_err(got.cpu(), want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_no_db_backward_at_head_dim_64(cuda_device, dtype, causal):
    """The backward kernel's no-db form at head pairs, as the fused op's
    backward calls it."""
    x = _qkv(6, 197, 12, 64, dtype, cuda_device, seed=15)
    do = _qkv(6, 197, 12, 64, dtype, cuda_device, seed=16)[..., :768].contiguous()
    dqkv, db = tfa._launch_bwd(x, None, do, 12, causal, with_db=False)
    torch.cuda.synchronize()
    assert db is None
    ref, _ = tfa.packed_short_attention_bwd_reference(x, do, 12, causal)
    assert _rel_err(dqkv, ref) <= TOL[dtype]
    again, _ = tfa._launch_bwd(x, None, do, 12, causal, with_db=False)
    assert torch.equal(again, dqkv)  # same bits on a repeat


@pytest.mark.cuda
def test_cuda_fused_kernel_raises_off_its_geometry(cuda_device):
    x, w, b = _fused_inputs(1, 10, 3, "bfloat16", cuda_device, seed=0)
    with pytest.raises(ValueError, match="even head count"):
        tfa._launch_fused(x, w, b, 3, False)
    with pytest.raises(ValueError, match="even head count"):
        tfa._launch_fused(x[..., :128], w[:128, :384], b[:384], 1, False)
    with pytest.raises(TypeError, match="storage type"):
        y, v, c = _fused_inputs(1, 10, 2, "float32", cuda_device, seed=0)
        tfa._launch_fused(y.half(), v.half(), c.half(), 2, False)


def _misaligned(x):
    """x's values in a contiguous view one element into its storage: a base
    address the kernels' 16-byte loads and the TMA cannot take as it is."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _grads_of(fn, inputs, dout):
    leaves = [t.detach().clone().requires_grad_(True) if t.is_floating_point() else t
              for t in inputs]
    out = fn(*leaves)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_misaligned_operands_are_copied(cuda_device, dtype):
    """Odd-offset views into each entry point (the packed attention with its
    bias, the flash attention, the fused projection + attention), forward and
    backward with a misaligned dout: the same bits as the aligned call."""
    def same(fn, inputs, dout):
        out, grads = _grads_of(fn, inputs, dout)
        out_m, grads_m = _grads_of(fn, [_misaligned(t) for t in inputs], _misaligned(dout))
        assert torch.equal(out_m, out)
        for g, g_m in zip(grads, grads_m):
            assert torch.equal(g_m, g)

    x = _qkv(3, 197, 12, 64, dtype, cuda_device, seed=5)
    b = torch.randn(3 * 768, generator=torch.Generator().manual_seed(6)).to(cuda_device, x.dtype)
    dout = torch.randn(3, 197, 768, generator=torch.Generator().manual_seed(7)).to(cuda_device,
                                                                                  x.dtype)
    _build.reset_launch_counts()
    same(lambda q, bias: tfa.packed_qkv_bias_attention(q, bias, 12), [x, b], dout)
    assert _build.launch_counts[tfa.KERNEL] == _build.launch_counts[tfa.BWD_KERNEL] == 2
    q, k, v, do = (_heads(2, 256, 4, 512, dtype, cuda_device, seed) for seed in range(10, 14))
    same(lambda *qkv: tfa.flash_attention(*qkv, True), [q, k, v], do)
    assert _build.launch_counts[tfa.FLASH_KERNEL] == _build.launch_counts[tfa.FLASH_BWD_KERNEL] == 2
    xf, w, bf = _fused_inputs(3, 197, 12, dtype, cuda_device, seed=15)
    wt = w.t()  # the weight (3C, C); the op takes its transposed view
    same(lambda x_, w_, b_: tfa.fused_qkv_attention(x_, w_.t(), b_, 12), [xf, wt, bf], dout)
    assert _build.launch_counts[tfa.FUSED_KERNEL] == 2


@pytest.mark.cuda
def test_cuda_train_net_runs_expts02_through_the_flash_kernels(cuda_device, tmp_path):
    """`train_net.cli` on expts/02 at 256 observed features, full width, on a
    synthetic EK100 tree of 64 train and 32 eval rows (chip_smoke.py's):
    one train step and one eval batch, 6 flash forward + 6 flash backward
    launches for the step and 6 forward launches for the eval, nothing else;
    a second call resumes from the checkpoint, trains nothing and evaluates."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    tree = chip_smoke.write_ek100_tree(str(tmp_path / "tree"), train_videos=2, eval_videos=1,
                                       actions_per_video=32, first_action_s=258, seed=4)
    argv = (["--config-file", os.path.join(root, chip_smoke.EXPT_02), "--run-dir",
             str(tmp_path / "run"), "train.num_epochs=1", "data_train.workers=4",
             "data_eval.workers=4"] + tree + chip_smoke.long_context(256))
    layers = 6
    want = {**{n: 0 for n in _build.KERNELS}, tfa.FLASH_KERNEL: 2 * layers,
            tfa.FLASH_BWD_KERNEL: layers}
    (metric,), rec = chip_smoke.run_train_net(argv)
    assert rec["launches"] == want and rec["epochs"] == [0] and np.isfinite(metric)
    assert "final_acc/action/AR5" in rec["finals"][0]
    (again,), rec = chip_smoke.run_train_net(argv)
    assert rec["launches"] == {**want, tfa.FLASH_KERNEL: layers, tfa.FLASH_BWD_KERNEL: 0}
    assert rec["epochs"] == [] and np.isfinite(again)


@pytest.mark.cuda
def test_cuda_train_net_runs_expts01_on_raw_video(cuda_device, tmp_path, monkeypatch):
    """`train_net.cli` on expts/01 at a ViT of 2 blocks (768 wide, 12 heads,
    f32) on a raw-video EK100 tree (chip_smoke.py's, 128x96 at 10 fps) read
    by the file's DefaultReader, the backbone from a timm file at the path
    the file names: one train step and one eval batch of 3 clips, 2 packed
    forward + 2 packed backward launches for the step and 2 forward for the
    eval, nothing else; a second call resumes and only evaluates."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    chip_smoke.write_timm_vit(str(tmp_path / chip_smoke.TIMM_IN21K), depth=2, seed=5)
    tree = chip_smoke.write_ek100_tree(str(tmp_path / "tree"), train_videos=1, eval_videos=1,
                                       actions_per_video=3, first_action_s=11, seed=6,
                                       video=(128, 96, 10))
    argv = (["--config-file", os.path.join(root, chip_smoke.EXPT_01), "--run-dir",
             str(tmp_path / "run"), "train.num_epochs=1", "data_train.workers=4",
             "data_eval.workers=4", "+model.backbone.depth=2"] + tree)
    layers = 2
    want = {**{n: 0 for n in _build.KERNELS}, tfa.KERNEL: 2 * layers, tfa.BWD_KERNEL: layers}
    (metric,), rec = chip_smoke.run_train_net(argv)
    assert rec["launches"] == want and rec["epochs"] == [0] and np.isfinite(metric)
    assert np.isfinite(rec["loggers"][0].meters["loss"].global_avg)
    (again,), rec = chip_smoke.run_train_net(argv)
    assert rec["launches"] == {**want, tfa.KERNEL: layers, tfa.BWD_KERNEL: 0}
    assert rec["epochs"] == [] and np.isfinite(again)


@pytest.mark.cuda
def test_cuda_bn_backbone_train_step_saves_and_reloads_running_stats(cuda_device, tmp_path):
    """One `make_train_step` step of an AVTModel on r2plus1d_18 (cuDNN's
    conv3d in f32, TF32 off): a finite loss, the running statistics moved
    by the step and not by an eval forward after it, and a checkpoint that
    restores them (and the weights) bit for bit into a fresh model."""
    from avt_tpu_torch.models import (
        AVTModel,
        IdentityAgg,
        IdentityFuture,
        LinearClassifier,
        MeanAgg,
        r2plus1d_18,
    )
    from avt_tpu_torch.models.flagship import init_weights
    from avt_tpu_torch.train import (
        build_optimizer,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    def model():
        m = AVTModel(backbone=r2plus1d_18(device=cuda_device), temporal_aggregator=MeanAgg(512),
                     future_predictor=IdentityFuture(512),
                     temporal_aggregator_after_future_pred=IdentityAgg(512),
                     classifiers={"action": LinearClassifier(512, 10, device=cuda_device)},
                     num_classes=(("action", 10),), backbone_dim=512, device=cuda_device)
        init_weights(m, torch.Generator(device=cuda_device).manual_seed(0))
        return m

    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = model()
        opt, _ = build_optimizer(net, [["__all__", 0.01, 1e-4]], iters_per_epoch=1,
                                 num_epochs=1, scheduler_name="constant")
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        batch = {"video": torch.randn(4, 1, 3, 8, 112, 112, device=cuda_device, generator=gen),
                 "target": {"action": torch.tensor([0, 3, 5, 9], device=cuda_device)}}
        stats0 = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
        metrics = make_train_step(net, opt, {"cls_action": 1.0}, {"action": 10})(batch)
        assert torch.isfinite(metrics["loss"])
        stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
        assert all(not torch.equal(stats[k], stats0[k]) for k in stats)
        with torch.no_grad():
            net.eval()(batch["video"])
        assert all(torch.equal(net.state_dict()[k], v) for k, v in stats.items())
        save_checkpoint(str(tmp_path), net, opt, 1.0)
        fresh = model()
        opt2, _ = build_optimizer(fresh, [["__all__", 0.01, 1e-4]], iters_per_epoch=1,
                                  num_epochs=1, scheduler_name="constant")
        assert restore_checkpoint(str(tmp_path), fresh, opt2) == 1.0
        want = net.state_dict()
        assert all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
    finally:
        torch.backends.cudnn.allow_tf32 = allow
