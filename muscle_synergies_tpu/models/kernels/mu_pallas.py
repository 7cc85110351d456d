"""Fused batched MU-NMF as a Pallas kernel through Triton.

The XLA fit (:func:`muscle_synergies_tpu.models.batch.fit_mu_batch`) is
a vmapped ``lax.while_loop``: every iteration issues several tiny
batched products, and every chunk of ``check_every`` iterations sends
its loop predicate back to the host.  Here one program solves one
trial to convergence: X, W and H stay in registers, and the only
memory traffic is the initial load and the final store
(:mod:`._triton` describes the layout and padding).

Numerics follow :func:`muscle_synergies_tpu.models.mu.mu_update`
(same update order, same float32-eps denominator guard) with exact
float32 multiply-adds, and the stopping rule follows
:func:`muscle_synergies_tpu.models.mu.fit_mu` per trial.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..mu import EPSILON
from ._triton import (
    add_all,
    call,
    col,
    load_h,
    load_rows,
    pack,
    rsum,
    store_h,
    store_rows,
    unpack,
)

__all__ = ["mu_iterations_pallas", "fit_mu_pallas"]


def _guard(den):
    return jnp.where(den == 0, EPSILON, den)


def _mu_step(x, w, h, inner_iter: int):
    """One MU update (W then H, sklearn's order) on list layouts.

    ``x``: L rows ``(1, n)``; ``w``: k rows ``(1, n)``; ``h``: k x L
    per-trial vectors ``(1,)``.  ``inner_iter > 1`` repeats each
    factor's update reusing the fixed factor's cross products, as
    :func:`muscle_synergies_tpu.models.mu.mu_update` does.
    """
    k, l = len(w), len(x)
    hht = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            hht[i][j] = hht[j][i] = add_all(
                [h[i][m] * h[j][m] for m in range(l)]
            )
    num = [add_all([col(h[i][m]) * x[m] for m in range(l)]) for i in range(k)]
    for _ in range(inner_iter):
        w = [
            w[i] * (num[i] / _guard(add_all(
                [col(hht[j][i]) * w[j] for j in range(k)]
            )))
            for i in range(k)
        ]

    wtw = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            wtw[i][j] = wtw[j][i] = rsum(w[i] * w[j])
    wtx = [[rsum(w[i] * x[m]) for m in range(l)] for i in range(k)]
    for _ in range(inner_iter):
        h = [
            [
                h[i][m] * (wtx[i][m] / _guard(add_all(
                    [wtw[i][j] * h[j][m] for j in range(k)]
                )))
                for m in range(l)
            ]
            for i in range(k)
        ]
    return w, h


def _error(x, w, h):
    """Per-trial ``||X - WH||_F``, shape ``(1,)``."""
    k = len(w)
    total = None
    for m, xm in enumerate(x):
        diff = xm - add_all([w[j] * col(h[j][m]) for j in range(k)])
        part = rsum(diff * diff)
        total = part if total is None else total + part
    return jnp.sqrt(total)


def _mu_kernel(x_ref, w_ref, h_ref, w_out, h_out, *, n_iters, k, l,
               inner_iter):
    x = load_rows(x_ref, l)

    def body(_, carry):
        return _mu_step(x, *carry, inner_iter=inner_iter)

    w, h = jax.lax.fori_loop(
        0, n_iters, body, (load_rows(w_ref, k), load_h(h_ref, k, l))
    )
    store_rows(w_out, w)
    store_h(h_out, h)


def _fit_mu_kernel(
    x_ref, w_ref, h_ref, w_out, h_out, n_iter_out, err_out,
    conv_out, *, max_iter, tol, check_every, k, l, inner_iter,
):
    """MU solve of one trial to convergence.

    :func:`muscle_synergies_tpu.models.mu.fit_mu`'s stopping rule:
    chunks of ``check_every`` updates, the relative Frobenius
    improvement tested at exact multiples of ``check_every``.
    """
    x = load_rows(x_ref, l)
    w0, h0 = load_rows(w_ref, k), load_h(h_ref, k, l)
    err0 = _error(x, w0, h0)
    conv0 = jnp.zeros(err0.shape, jnp.int32)

    def cond(state):
        n_iter, conv = state[2], state[4]
        return jnp.logical_and(jnp.max(n_iter) < max_iter, jnp.min(conv) < 1)

    def chunk(state):
        w, h, n_iter, prev_err, conv = state
        steps = jnp.minimum(check_every, max_iter - jnp.max(n_iter))

        def body(_, carry):
            return _mu_step(x, *carry, inner_iter=inner_iter)

        w, h = jax.lax.fori_loop(0, steps, body, (w, h))
        n_iter = n_iter + steps
        if tol > 0:
            err = _error(x, w, h)
            conv = jnp.logical_and(
                (prev_err - err) / err0 < tol, n_iter % check_every == 0
            ).astype(jnp.int32)
            # the converging check still records its error, as
            # MUState.previous_error does
            prev_err = err
        return w, h, n_iter, prev_err, conv

    init = (w0, h0, jnp.zeros_like(conv0), err0, conv0)
    w, h, n_iter, prev_err, conv = jax.lax.while_loop(cond, chunk, init)
    store_rows(w_out, w)
    store_h(h_out, h)
    n_iter_out[:] = n_iter
    err_out[:] = prev_err
    conv_out[:] = conv


@functools.partial(
    jax.jit, static_argnames=("n_iters", "interpret", "inner_iter")
)
def mu_iterations_pallas(xs, w, h, n_iters: int, interpret: bool = False,
                         inner_iter: int = 1):
    """Run ``n_iters`` MU iterations on a ``(B, N, L)`` batch.

    Drop-in for
    :func:`muscle_synergies_tpu.models.batch.mu_iterations_batch`; any
    batch size and trial length (samples are padded internally).
    """
    _, n, l = xs.shape
    k = w.shape[-1]
    xt, wt = pack(xs, w)
    kernel = functools.partial(
        _mu_kernel, n_iters=n_iters, k=k, l=l, inner_iter=inner_iter
    )
    wt, h = call(
        kernel, (xt, wt, h),
        [jax.ShapeDtypeStruct(wt.shape, w.dtype),
         jax.ShapeDtypeStruct(h.shape, h.dtype)],
        name="mu_iterations", interpret=interpret,
    )
    return unpack(wt, n), h


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "check_every", "interpret", "inner_iter",
    ),
)
def fit_mu_pallas(xs, w0, h0, max_iter: int = 200, tol: float = 1e-4,
                  check_every: int = 10, interpret: bool = False,
                  inner_iter: int = 1):
    """MU-NMF to convergence on a ``(B, N, L)`` batch in one launch.

    Same stopping semantics as
    :func:`muscle_synergies_tpu.models.mu.fit_mu` (sklearn's rule, per
    trial, each trial stopping on its own).

    Returns:
        ``(w, h, n_iter, prev_err, converged)`` with per-trial ``(B,)``
        iteration counts, the Frobenius error at each trial's last
        convergence check (``MUState.previous_error``) and convergence
        flags.
    """
    b, n, l = xs.shape
    k = w0.shape[-1]
    xt, wt = pack(xs, w0)
    kernel = functools.partial(
        _fit_mu_kernel, max_iter=max_iter, tol=float(tol),
        check_every=check_every, k=k, l=l, inner_iter=inner_iter,
    )
    wt, h, n_iter, prev_err, conv = call(
        kernel, (xt, wt, h0),
        [jax.ShapeDtypeStruct(wt.shape, w0.dtype),
         jax.ShapeDtypeStruct(h0.shape, h0.dtype),
         jax.ShapeDtypeStruct((b,), jnp.int32),
         jax.ShapeDtypeStruct((b,), xs.dtype),
         jax.ShapeDtypeStruct((b,), jnp.int32)],
        name="mu_fit", interpret=interpret,
    )
    return unpack(wt, n), h, n_iter, prev_err, conv.astype(bool)
