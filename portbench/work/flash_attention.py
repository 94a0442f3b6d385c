"""Bytes and operations of the flash attention (`avt_tpu_torch::
flash_attention` and its backward) at one call's shapes: B sequences of T
queries over T keys, H heads of D; operations count only the (query, key)
pairs a causal mask keeps, each input read once and each output written
once.

Forward: q, k, v in, out and the f32 log-sum-exp out; QK^T and PV,
4 B H pairs D. Backward: q, k, v, dout, lse and delta in, dq, dk, dv out;
S, dP, dQ, dK, dV, 10 B H pairs D.
"""
from __future__ import annotations


def pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


def forward_work(B: int, T: int, H: int, D: int, itemsize: int, causal: bool):
    rows = B * T * H * D
    return 4 * rows * itemsize + B * H * T * 4, 4 * B * H * pairs(T, causal) * D


def backward_work(B: int, T: int, H: int, D: int, itemsize: int, causal: bool):
    rows = B * T * H * D
    return 7 * rows * itemsize + 2 * B * H * T * 4, 10 * B * H * pairs(T, causal) * D
