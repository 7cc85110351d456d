"""Multiplicative-update NMF solver as a fused JAX loop.

Implements the Frobenius-objective multiplicative updates with the
exact semantics of ``sklearn.decomposition._nmf._fit_multiplicative_update``
(the engine behind the reference's ``find_synergies``; reference
analysis.py:848-864 wraps ``sklearn.decomposition.NMF``):

- W update: ``W *= (X Ht) / (W (H Ht))``, H update symmetric;
- zero denominators replaced by float32 machine eps (sklearn EPSILON);
- optional L1/L2 penalties added to the denominators;
- convergence test every 10 iterations on the Frobenius error
  ``||X - WH||_F``: stop when ``(prev - err) / err_init < tol``.

The whole fit is a ``lax.while_loop`` whose body performs a chunk of
updates, so one XLA computation runs to convergence on device with zero
host round-trips.  Under ``vmap`` the loop freezes converged trials
while the rest keep iterating, giving exact per-trial stopping at batch
throughput — the device replacement for the reference's sequential
per-trial Python loop (analysis.py:909-913).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# sklearn's EPSILON: np.finfo(np.float32).eps, independent of dtype.
EPSILON = 1.1920929e-07

__all__ = [
    "EPSILON", "full_precision", "mu_update", "frobenius_error", "fit_mu",
    "MUState",
]


def full_precision(fn):
    """Trace ``fn``'s matrix products at full float32 precision.

    A GPU's default float32 product may round its inputs to TF32
    (about three decimal digits): on an H100 that moved the XLA MU and
    CD fits of a 1024 x 200 x 8, rank-4 batch 7.6e-3 and 2.3e-2 from the
    float64 host fit, and CD's stopping iteration by 56, against 4.9e-6
    and 1.3e-5 at full precision.  It costs time: on a 400 W H100 the
    XLA MU fit of that batch went from 30.9 to 45.3 ms (+47%) and the
    CD fit from 42.1 to 45.6 ms (+8%).  Every fit that stays on XLA pays
    it: rank sweeps above the kernels' rank limit (the CLI's default
    1..10), penalized fits, the sharded solvers, cNMF and NM3F.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def frobenius_error(
    x: jnp.ndarray, w: jnp.ndarray, h: jnp.ndarray, precision=None
) -> jnp.ndarray:
    """``||X - W @ H||_F`` (sklearn's square-root beta divergence, beta=2).

    ``precision`` sets the reconstruction matmul's precision; stopping
    criteria pass ``jax.lax.Precision.HIGHEST`` (sklearn computes this
    statistic with exact-f32 numpy matmuls, and a reduced-precision
    default product perturbs it enough to flip near-threshold relative-
    improvement decisions).
    """
    diff = x - jnp.matmul(w, h, precision=precision)
    return jnp.sqrt(jnp.sum(diff * diff))


@full_precision
def mu_update(
    x: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
    update_h: bool = True,
):
    """One multiplicative update of W then H (sklearn's order).

    ``inner_iter > 1`` repeats each factor's update while reusing the
    expensive cross products ``X Ht`` / ``Wt X`` and the Gram of the
    fixed factor (the accelerated MU of Gillis & Glineur 2012,
    arXiv:1107.5194) — more objective decrease per byte of X touched.
    ``inner_iter=1`` is exactly sklearn's update.  ``update_h=False``
    freezes H (sklearn's ``transform`` path).
    """
    # W updates: X Ht and H Ht are constant while H is fixed
    xht = x @ h.T
    hht = h @ h.T
    for _ in range(inner_iter):
        denominator = w @ hht
        if l1_reg_w > 0:
            denominator = denominator + l1_reg_w
        if l2_reg_w > 0:
            denominator = denominator + l2_reg_w * w
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        w = w * (xht / denominator)

    if not update_h:
        return w, h

    # H updates: Wt X and Wt W are constant while W is fixed
    wtx = w.T @ x
    wtw = w.T @ w
    for _ in range(inner_iter):
        denominator = wtw @ h
        if l1_reg_h > 0:
            denominator = denominator + l1_reg_h
        if l2_reg_h > 0:
            denominator = denominator + l2_reg_h * h
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        h = h * (wtx / denominator)
    return w, h


class MUState(NamedTuple):
    w: jnp.ndarray
    h: jnp.ndarray
    n_iter: jnp.ndarray  # int32
    previous_error: jnp.ndarray
    converged: jnp.ndarray  # bool


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "tol", "check_every", "l1_reg_w", "l2_reg_w",
                     "l1_reg_h", "l2_reg_h", "inner_iter", "update_h"),
)
def fit_mu(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
    update_h: bool = True,
) -> MUState:
    """Run MU-NMF to convergence on device.

    Args:
        x: ``(N, L)`` non-negative matrix (zero-padded rows are fine as
            long as the matching rows of ``w0`` are zero).
        w0, h0: initial factors ``(N, k)`` / ``(k, L)``.
        max_iter: iteration cap (sklearn counts one W+H update as one
            iteration).
        tol: relative Frobenius improvement threshold; ``tol=0``
            disables the convergence check (always runs ``max_iter``).
        check_every: cadence of the convergence test (sklearn uses 10).

    Returns:
        :class:`MUState` with final factors, iterations done, the error
        at the last convergence check and the convergence flag.

    The stopping statistic and the updates run their products at full
    float32 precision (see :func:`frobenius_error` and
    :func:`full_precision`).
    """
    _hi = jax.lax.Precision.HIGHEST
    error_at_init = frobenius_error(x, w0, h0, precision=_hi)

    def chunk(state: MUState) -> MUState:
        # Run up to `check_every` updates, stopping the counter at
        # max_iter like sklearn's 1..max_iter loop.
        steps = jnp.minimum(check_every, max_iter - state.n_iter)

        def body(_, wh):
            w, h = wh
            return mu_update(x, w, h, l1_reg_w, l2_reg_w,
                             l1_reg_h, l2_reg_h, inner_iter, update_h)

        w, h = jax.lax.fori_loop(0, steps, body, (state.w, state.h))
        n_iter = state.n_iter + steps
        if tol > 0:
            error = frobenius_error(x, w, h, precision=_hi)
            converged = (state.previous_error - error) / error_at_init < tol
            # sklearn only tests at exact multiples of `check_every`.
            at_checkpoint = n_iter % check_every == 0
            converged = jnp.logical_and(converged, at_checkpoint)
            return MUState(w, h, n_iter, error, converged)
        return MUState(w, h, n_iter, state.previous_error, state.converged)

    def cond(state: MUState) -> jnp.ndarray:
        return jnp.logical_and(state.n_iter < max_iter, ~state.converged)

    init = MUState(
        w=jnp.asarray(w0),
        h=jnp.asarray(h0),
        n_iter=jnp.zeros((), jnp.int32),
        previous_error=error_at_init,
        converged=jnp.zeros((), bool),
    )
    return jax.lax.while_loop(cond, chunk, init)
