"""What the benchmark makes from `--seed` and hands to both sides: the
weights and the train step's random draws."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

_RAND = torch.rand  # the draws' own, which `Draws.patched` leaves alone


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed of (seed, keys): any whole --seed, large ones too."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, keys)]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...], float, float]], seed: int,
                 device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """f32 weights mean + std * N(0, 1), in one draw on `device`: (the flat
    buffer, {name: view of it})."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, mean, std), n in zip(specs, sizes):
        view = flat[at:at + n].view(shape)
        view.mul_(std).add_(mean)
        out[name] = view
        at += n
    return flat, out


class Draws:
    """The uniform draws of one train step: draw k is torch.rand of its
    shape from a generator seeded (seed, step, k), so any side can make it
    again. The program consumes them through `patched()` (every torch.rand
    inside comes from here, and its shape is recorded); the reference
    through `slice`, row blocks of the same draws in the same order."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step, self.device = seed, step, device
        self.shapes: List[Tuple[int, ...]] = []
        self.k = 0
        self.mismatch: Optional[str] = None
        self.open = True  # no program step took them: the reference's first block sets them

    def make(self, k: int, shape) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, self.step, k))
        return _RAND(tuple(shape), generator=gen, device=self.device)

    @contextlib.contextmanager
    def patched(self):
        self.open = False

        def draw(*size, generator=None, device=None, dtype=None, **kwargs):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
            x = self.make(len(self.shapes), shape)
            self.shapes.append(tuple(shape))
            return x if dtype is None else x.to(dtype)

        with mock.patch.object(torch, "rand", draw):
            yield

    def slice(self, b0: int, b1: int, B: int):
        """Draws for rows b0:b1 of a B-row batch."""
        def draw(shape):
            k = self.k
            if self.open and b0 == 0 and k == len(self.shapes):
                self.shapes.append((B,) + tuple(shape[1:]))
            full = tuple(self.shapes[k]) if k < len(self.shapes) else None
            want = (B,) + tuple(shape[1:])
            if full != want or shape[0] != b1 - b0:
                self.mismatch = (f"step {self.step}: the reference's draw {k} of shape "
                                 f"{want} (rows {b0}:{b1}) against the program's {full}")
            self.k += 1
            return self.make(k, want)[b0:b1]
        return draw

    def rewind(self) -> None:
        """Back to draw 0 for the next block of rows; a block has to have
        taken every draw the program's step took."""
        if self.k != len(self.shapes) and self.mismatch is None:
            self.mismatch = (f"step {self.step}: the reference took {self.k} draws, the "
                             f"program {len(self.shapes)}")
        self.k = 0
