"""Bytes and operations of the packed short-sequence attention (the ViT's
`avt_tpu_torch::packed_short_attention` and its backward) at one call's
shapes: N sequences of T tokens, H heads of D, each input read once and
each output written once.

Forward: packed qkv (N, T, 3C) and its bias (3C) in, out (N, T, C);
QK^T and PV, 4 N H T^2 D. Backward with the bias gradient: qkv and dout
in, dqkv out, the bias in and db out; S, dP, dQ, dK, dV, 10 N H T^2 D.
"""
from __future__ import annotations


def forward_work(N: int, T: int, H: int, D: int, itemsize: int):
    C = H * D
    return (N * T * 3 * C + 3 * C + N * T * C) * itemsize, 4 * N * H * T * T * D


def backward_work(N: int, T: int, H: int, D: int, itemsize: int):
    C = H * D
    nbytes = (N * T * 3 * C + N * T * C + N * T * 3 * C + 2 * 3 * C) * itemsize
    return nbytes, 10 * N * H * T * T * D
