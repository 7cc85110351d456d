"""HALS / coordinate-descent NMF solver (sklearn 'cd'-equivalent) in JAX.

Replicates ``sklearn.decomposition._nmf._fit_coordinate_descent`` with
``shuffle=False`` — the default solver behind the reference's
``find_synergies`` (reference analysis.py:862 creates ``NMF()`` whose
default solver is ``'cd'``):

- per outer iteration, W is updated by one cyclic pass of coordinate
  descent with H fixed, then H symmetrically (via ``X.T``);
- within one component's pass the per-sample updates are independent,
  so each coordinate pass vectorizes over samples — the sequential part
  is only the (small, static) component loop, which unrolls;
- L2 regularization adds to the Gram diagonal, L1 subtracts from
  ``X Ht``;
- stopping: total |projected gradient| (violation) relative to the
  first iteration's, ``violation / violation_init <= tol``.

This is HALS (Cichocki & Phan 2009) expressed with rank-1 Gram updates,
which keeps every inner step a fused matvec.

Unlike the MU/beta/cNMF/NM3F fits, the stopping statistic here cannot
be decoupled from the update precision: the violation is a byproduct
of the coordinate pass itself (per-update projected-gradient deltas).
So the pass runs its products at full float32 precision
(:func:`~muscle_synergies_tpu.models.mu.full_precision`), as the fused
kernel (``models.kernels.fit_cd_pallas``) does with exact float32
multiply-adds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .mu import full_precision

__all__ = ["cd_pass", "fit_cd", "CDState"]


@full_precision
def cd_pass(
    x: jnp.ndarray,
    w: jnp.ndarray,
    ht: jnp.ndarray,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
):
    """One cyclic coordinate-descent pass updating ``w`` (``ht`` fixed).

    Mirrors sklearn's ``_update_coordinate_descent`` +
    ``_update_cdnmf_fast`` with ``shuffle=False``: for each component
    ``s`` in order, the gradient of the objective w.r.t. ``W[:, s]`` is
    ``W @ HHt[:, s] - XHt[:, s]`` and the Newton step divides by
    ``HHt[s, s]``, clipped at zero.

    Returns:
        ``(w_new, violation)`` where violation is the summed absolute
        projected gradient (sklearn's stopping statistic).
    """
    n_components = ht.shape[1]
    hht = ht.T @ ht
    xht = x @ ht
    if l2_reg != 0.0:
        hht = hht + l2_reg * jnp.eye(n_components, dtype=hht.dtype)
    if l1_reg != 0.0:
        xht = xht - l1_reg

    violation = jnp.zeros((), x.dtype)
    for s in range(n_components):  # static unroll: k is small
        grad = w @ hht[:, s] - xht[:, s]
        pg = jnp.where(w[:, s] == 0.0, jnp.minimum(grad, 0.0), grad)
        violation = violation + jnp.sum(jnp.abs(pg))
        hess = hht[s, s]
        new_col = jnp.maximum(w[:, s] - grad / jnp.where(hess == 0, 1.0, hess), 0.0)
        w = w.at[:, s].set(jnp.where(hess != 0, new_col, w[:, s]))
    return w, violation


class CDState(NamedTuple):
    w: jnp.ndarray
    ht: jnp.ndarray
    n_iter: jnp.ndarray
    violation_init: jnp.ndarray
    converged: jnp.ndarray


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "tol", "l1_reg_w", "l2_reg_w", "l1_reg_h",
                     "l2_reg_h", "update_h"),
)
def fit_cd(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
) -> CDState:
    """Run coordinate-descent NMF to convergence on device.

    Returns:
        :class:`CDState`; read factors as ``state.w`` and
        ``state.ht.T``.
    """
    xt = x.T

    def body(state: CDState) -> CDState:
        w, violation_w = cd_pass(x, state.w, state.ht, l1_reg_w, l2_reg_w)
        if update_h:
            ht, violation_h = cd_pass(xt, state.ht, w, l1_reg_h, l2_reg_h)
        else:
            ht, violation_h = state.ht, jnp.zeros((), x.dtype)
        violation = violation_w + violation_h
        n_iter = state.n_iter + 1
        violation_init = jnp.where(
            n_iter == 1, violation, state.violation_init
        )
        converged = jnp.logical_or(
            violation_init == 0, violation / violation_init <= tol
        )
        return CDState(w, ht, n_iter, violation_init, converged)

    def cond(state: CDState) -> jnp.ndarray:
        return jnp.logical_and(state.n_iter < max_iter, ~state.converged)

    init = CDState(
        w=jnp.asarray(w0),
        ht=jnp.asarray(h0).T,
        n_iter=jnp.zeros((), jnp.int32),
        violation_init=jnp.zeros((), x.dtype),
        converged=jnp.zeros((), bool),
    )
    return jax.lax.while_loop(cond, body, init)
