"""Fused batched HALS/coordinate-descent NMF as a Pallas kernel (Triton).

Companion to :mod:`.mu_pallas` for the ``'cd'`` solver, sklearn's
default and the :class:`~muscle_synergies_tpu.utils.config.PipelineConfig`
default.  The XLA fit unrolls k coordinate updates per half-step inside
a vmapped ``lax.while_loop`` whose predicate returns to the host every
iteration; here one program runs one trial to convergence with its
factors in registers.

One outer iteration is one cyclic coordinate pass over W's components
(H fixed) followed by one over H's (W fixed): the update order of
:func:`muscle_synergies_tpu.models.hals.cd_pass` with ``shuffle=False``,
so the iterates match the XLA solver's up to float reordering.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

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

__all__ = ["cd_iterations_pallas", "fit_cd_pallas"]


def _newton(v, grad, hess, bcast):
    """Projected Newton step of one coordinate, skipped where hess == 0."""
    safe = jnp.where(hess == 0, 1.0, hess)
    new = jnp.maximum(v - grad / bcast(safe), 0.0)
    return jnp.where(bcast(hess) != 0, new, v)


def _cd_iteration(x, w, h, with_violation: bool):
    """One outer CD iteration (W pass then H pass) on list layouts.

    Returns ``(w, h, violation)``: the summed absolute projected
    gradient of both passes per trial (sklearn's stopping statistic,
    ``(1,)``), or ``None`` when ``with_violation=False``.
    """
    k, l = len(w), len(x)
    violation = None

    def add_violation(v, pg_sum):
        return pg_sum if v is None else v + pg_sum

    # ---- W pass: cyclic over components, H fixed ----
    hht = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            hht[i][j] = hht[j][i] = add_all(
                [h[i][m] * h[j][m] for m in range(l)]
            )
    xht = [add_all([col(h[s][m]) * x[m] for m in range(l)]) for s in range(k)]
    w = list(w)
    for s in range(k):
        grad = add_all([col(hht[j][s]) * w[j] for j in range(k)]) - xht[s]
        if with_violation:
            pg = jnp.where(w[s] == 0.0, jnp.minimum(grad, 0.0), grad)
            violation = add_violation(violation, rsum(jnp.abs(pg)))
        w[s] = _newton(w[s], grad, hht[s][s], col)

    # ---- H pass: cyclic over components, W fixed ----
    wtw = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            wtw[i][j] = wtw[j][i] = rsum(w[i] * w[j])
    wtx = [[rsum(w[s] * x[m]) for m in range(l)] for s in range(k)]
    h = [list(row) for row in h]
    for s in range(k):
        grads = [
            add_all([wtw[j][s] * h[j][m] for j in range(k)]) - wtx[s][m]
            for m in range(l)
        ]
        if with_violation:
            pg = [
                jnp.abs(jnp.where(h[s][m] == 0.0, jnp.minimum(g, 0.0), g))
                for m, g in enumerate(grads)
            ]
            violation = add_violation(violation, add_all(pg))
        h[s] = [
            _newton(h[s][m], grads[m], wtw[s][s], lambda v: v)
            for m in range(l)
        ]
    return w, h, violation


def _cd_kernel(x_ref, w_ref, h_ref, w_out, h_out, *, n_iters, k, l):
    x = load_rows(x_ref, l)

    def body(_, carry):
        w, h, _ = _cd_iteration(x, *carry, with_violation=False)
        return w, h

    w, h = jax.lax.fori_loop(
        0, n_iters, body, (load_rows(w_ref, k), load_h(h_ref, k, l))
    )
    store_rows(w_out, w)
    store_h(h_out, h)


def _fit_cd_kernel(
    x_ref, w_ref, h_ref, w_out, h_out, n_iter_out, viol_out,
    conv_out, *, max_iter, tol, k, l,
):
    """CD solve of one trial to sklearn's violation-based convergence.

    :func:`muscle_synergies_tpu.models.hals.fit_cd`'s rule: the first
    iteration's violation is the reference level, convergence when
    ``violation / violation_init <= tol`` (or a zero first violation).
    """
    x = load_rows(x_ref, l)

    def cond(state):
        n_iter, conv = state[2], state[4]
        return jnp.logical_and(jnp.max(n_iter) < max_iter, jnp.min(conv) < 1)

    def body(state):
        w, h, n_iter, viol_init, _ = state
        w, h, viol = _cd_iteration(x, w, h, with_violation=True)
        n_iter = n_iter + 1
        viol_init = jnp.where(n_iter == 1, viol, viol_init)
        safe = jnp.where(viol_init == 0, 1.0, viol_init)
        conv = jnp.logical_or(viol_init == 0, viol / safe <= tol)
        return w, h, n_iter, viol_init, conv.astype(jnp.int32)

    zero_i = jnp.zeros(x[0].shape[:1], jnp.int32)
    init = (load_rows(w_ref, k), load_h(h_ref, k, l), zero_i,
            zero_i.astype(x[0].dtype), zero_i)
    w, h, n_iter, viol_init, conv = jax.lax.while_loop(cond, body, init)
    store_rows(w_out, w)
    store_h(h_out, h)
    n_iter_out[:] = n_iter
    viol_out[:] = viol_init
    conv_out[:] = conv


@functools.partial(
    jax.jit, static_argnames=("max_iter", "tol", "interpret")
)
def fit_cd_pallas(xs, w0, h0, max_iter: int = 200, tol: float = 1e-4,
                  interpret: bool = False):
    """CD-NMF to convergence on a ``(B, N, L)`` batch in one launch.

    Same stopping semantics as
    :func:`muscle_synergies_tpu.models.hals.fit_cd` (sklearn's
    projected-gradient rule, per trial, each trial stopping on its own).

    Returns:
        ``(w, h, n_iter, violation_init, converged)`` with per-trial
        ``(B,)`` iteration counts, first-iteration violations and
        convergence flags; ``h`` is ``(B, k, L)``.
    """
    b, n, l = xs.shape
    k = w0.shape[-1]
    xt, wt = pack(xs, w0)
    kernel = functools.partial(
        _fit_cd_kernel, max_iter=max_iter, tol=float(tol), k=k, l=l
    )
    wt, h, n_iter, viol_init, conv = call(
        kernel, (xt, wt, h0),
        [jax.ShapeDtypeStruct(wt.shape, w0.dtype),
         jax.ShapeDtypeStruct(h0.shape, h0.dtype),
         jax.ShapeDtypeStruct((b,), jnp.int32),
         jax.ShapeDtypeStruct((b,), xs.dtype),
         jax.ShapeDtypeStruct((b,), jnp.int32)],
        name="cd_fit", interpret=interpret,
    )
    return unpack(wt, n), h, n_iter, viol_init, conv.astype(bool)


@functools.partial(jax.jit, static_argnames=("n_iters", "interpret"))
def cd_iterations_pallas(xs, w, h, n_iters: int, interpret: bool = False):
    """Run ``n_iters`` HALS/CD outer iterations on a ``(B, N, L)`` batch.

    ``fit_cd``'s update order without its stopping rule: the
    fixed-iteration throughput path.
    """
    _, n, l = xs.shape
    k = w.shape[-1]
    xt, wt = pack(xs, w)
    kernel = functools.partial(_cd_kernel, n_iters=n_iters, k=k, l=l)
    wt, h = call(
        kernel, (xt, wt, h),
        [jax.ShapeDtypeStruct(wt.shape, w.dtype),
         jax.ShapeDtypeStruct(h.shape, h.dtype)],
        name="cd_iterations", interpret=interpret,
    )
    return unpack(wt, n), h
