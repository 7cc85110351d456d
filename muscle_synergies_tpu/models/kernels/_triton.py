"""Shared layout and launch code for the Triton solver kernels.

Every kernel runs a whole solve for one trial in one one-warp program,
with the trial's factors held in registers across all iterations; the
grid covers the batch.  Every reduction over samples is then a warp
shuffle, with no shared-memory barrier, and a solve's time is its
serial chain of reductions: on an H100 (1024 x 200 x 8, rank 4, tol
1e-4) the MU / CD fits took 2.6 / 2.4 ms this way, against 4.6-5.9 ms
with 2-8 trials on 2-8 warps and 24-156 ms where a thread's share of
the rows spilled its registers.

The per-trial products (k of about 4, L of about 8) are far below the
tensor cores' minimum tile, so the kernels spell them out as unrolled
float32 multiply-adds over Python lists of ``(1, n_pad)`` rows; Triton
has no general concatenate, so nothing is ever stacked inside a kernel.

Layout: ``X (B, L, N_pad)``, ``W (B, k, N_pad)``, ``H (B, k, L)``.
Samples ride the contiguous minor axis, padded with zero rows to a
power of two (Triton's block sizes must be powers of two).  Zero rows
of X with zero rows of W stay zero under every update here and add
nothing to any Gram, error or violation, so the padding leaves the
factors unchanged; the beta kernels mask their quotient weights on the
padded rows, where ``WH`` would be clamped to epsilon.
"""

from __future__ import annotations

import functools
import operator

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

NUM_WARPS = 1


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def add_all(terms):
    """Left-to-right sum of a non-empty sequence of arrays."""
    return functools.reduce(operator.add, terms)


def pack(xs, w):
    """``(B, N, L)``, ``(B, N, k)`` -> kernel layout, samples padded."""
    n = xs.shape[1]
    pad_n = ((0, 0), (0, 0), (0, next_pow2(n) - n))
    return (jnp.pad(jnp.swapaxes(xs, 1, 2), pad_n),
            jnp.pad(jnp.swapaxes(w, 1, 2), pad_n))


def unpack(wt, n: int):
    """Inverse of :func:`pack` for ``W``."""
    return jnp.swapaxes(wt[:, :, :n], 1, 2)


def _spec(shape):
    rest = (0,) * (len(shape) - 1)
    return pl.BlockSpec((1,) + tuple(shape[1:]), lambda i: (i,) + rest)


def call(kernel, args, out_shapes, *, name: str, interpret: bool):
    """Launch ``kernel`` once per trial through Pallas' Triton route.

    Every operand and result is blocked to one trial along its leading
    axis and whole along the others.
    """
    return pl.pallas_call(
        kernel,
        grid=(args[0].shape[0],),
        in_specs=[_spec(a.shape) for a in args],
        out_specs=[_spec(s.shape) for s in out_shapes],
        out_shape=out_shapes,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(*args)


def load_rows(ref, count: int):
    """``ref[:, i, :]`` for ``i < count`` as a list of ``(1, n_pad)``."""
    return [ref[:, i, :] for i in range(count)]


def load_h(ref, k: int, l: int):
    """``H`` as a ``k x l`` nested list of per-trial ``(1,)`` vectors."""
    return [[ref[:, i, m] for m in range(l)] for i in range(k)]


def store_rows(ref, rows):
    for i, row in enumerate(rows):
        ref[:, i, :] = row


def store_h(ref, h):
    for i, row in enumerate(h):
        for m, v in enumerate(row):
            ref[:, i, m] = v


def col(v):
    """A per-trial ``(1,)`` vector as a ``(1, 1)`` column."""
    return v[:, None]


def rsum(a):
    """Sum a ``(1, n_pad)`` row block over its samples."""
    return jnp.sum(a, axis=1)
