"""Beta-divergence multiplicative-update NMF (KL, Itakura-Saito, general beta).

The reference forwards ``**sklearn_kwargs`` straight into
``sklearn.decomposition.NMF`` (reference analysis.py:718-720,862), so a
reference user can request ``beta_loss='kullback-leibler'`` or
``'itakura-saito'`` with ``solver='mu'``.  This module reproduces
sklearn's ``_fit_multiplicative_update`` for ``beta_loss != 2``
branch-for-branch (sklearn _nmf.py: ``_multiplicative_update_w/_h``,
``_beta_divergence``) as jitted XLA programs:

- numerators/denominators with the same EPSILON (float32-eps) clamps,
  applied in the same places (``WH`` clamped where a negative power
  would blow up; final denominator zeros replaced);
- sklearn's gamma exponent (``1/(2-beta)`` for ``beta < 1``,
  ``1/(beta-1)`` for ``beta > 2``, else 1);
- the stability flushes (``W[W < float64-eps] = 0`` for ``beta < 1``,
  same for H when ``beta <= 1``);
- the stopping rule: beta-divergence (square-rooted, sklearn's
  ``square_root=True``) every ``check_every`` iterations,
  ``(previous - current) / at_init < tol``.

The Frobenius case (``beta == 2``) lives in
:mod:`muscle_synergies_tpu.models.mu` with its Gram-matrix fast path
and Pallas kernels; this module is the general-beta complement.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .mu import EPSILON, full_precision

# sklearn's stability-flush threshold (np.finfo(np.float64).eps)
F64_EPS = float(np.finfo(np.float64).eps)

__all__ = ["beta_divergence", "mu_update_beta", "fit_mu_beta", "BetaState"]


def beta_loss_to_float(beta_loss) -> float:
    """sklearn's string-to-float mapping for ``beta_loss``.

    Example:
        >>> beta_loss_to_float("kullback-leibler")
        1.0
        >>> beta_loss_to_float(1.5)
        1.5
    """
    mapping = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}
    if isinstance(beta_loss, str):
        try:
            return mapping[beta_loss]
        except KeyError:
            raise ValueError(
                f"Invalid beta_loss parameter: got {beta_loss!r} instead of "
                f"one of {sorted(mapping)}, or a float"
            ) from None
    return float(beta_loss)


def _gamma(beta: float) -> float:
    """sklearn's MU exponent for general beta."""
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


@functools.partial(
    jax.jit, static_argnames=("beta", "square_root", "precision")
)
def beta_divergence(
    x, w, h, beta: float, square_root: bool = True, precision=None
):
    """sklearn's ``_beta_divergence`` for dense inputs.

    Entries with ``x <= EPSILON`` are excluded from the data-dependent
    terms, exactly as sklearn's ``indices = X_data > EPSILON`` mask —
    including the quirk that the Itakura-Saito constant counts *all*
    entries (``np.prod(X.shape)``), not only the masked ones.

    Args:
        precision: matmul precision for the ``W @ H`` reconstruction.
            A reduced-precision default product (TF32 on a GPU) is
            enough noise in the log terms to flip relative-improvement
            stopping decisions; convergence checks pass
            ``jax.lax.Precision.HIGHEST``.
    """
    if beta == 2.0:
        res = jnp.sum((x - jnp.matmul(w, h, precision=precision)) ** 2) / 2.0
        return jnp.sqrt(jnp.maximum(res * 2.0, 0.0)) if square_root else res

    wh = jnp.matmul(w, h, precision=precision)
    mask = x > EPSILON
    whc = jnp.maximum(wh, EPSILON)
    div = jnp.where(mask, x / whc, 1.0)

    if beta == 1.0:
        log_term = jnp.sum(jnp.where(mask, x * jnp.log(div), 0.0))
        sum_wh = jnp.dot(
            jnp.sum(w, axis=0), jnp.sum(h, axis=1), precision=precision
        )
        res = log_term + sum_wh - jnp.sum(jnp.where(mask, x, 0.0))
    elif beta == 0.0:
        res = (
            jnp.sum(jnp.where(mask, div, 0.0))
            - x.size
            - jnp.sum(jnp.where(mask, jnp.log(div), 0.0))
        )
    else:
        sum_wh_beta = jnp.sum(wh**beta)
        sum_x_wh = jnp.sum(jnp.where(mask, x * whc ** (beta - 1.0), 0.0))
        res = jnp.sum(jnp.where(mask, x**beta, 0.0)) - beta * sum_x_wh
        res = res + sum_wh_beta * (beta - 1.0)
        res = res / (beta * (beta - 1.0))

    if square_root:
        return jnp.sqrt(2.0 * jnp.maximum(res, 0.0))
    return res


def _wh_pow_times_x(x, wh, beta: float):
    """``(WH)^(beta-2) * X`` with sklearn's sub-EPSILON clamp."""
    if beta - 2.0 < 0:
        wh = jnp.maximum(wh, EPSILON)
    if beta == 1.0:
        return x / wh
    if beta == 0.0:
        return x * wh**-2
    return x * wh ** (beta - 2.0)


@full_precision
def mu_update_beta(
    x,
    w,
    h,
    beta: float,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
):
    """One sklearn-order MU iteration for general beta (W then H).

    ``update_h=False`` freezes H (sklearn's ``transform`` path).
    """
    gamma = _gamma(beta)

    # ---- W update ----
    wh = w @ h
    numerator = _wh_pow_times_x(x, wh, beta) @ h.T
    if beta == 1.0:
        denominator = jnp.broadcast_to(jnp.sum(h, axis=1)[None, :], w.shape)
    else:
        whd = jnp.maximum(wh, EPSILON) if beta - 1.0 < 0 else wh
        denominator = whd ** (beta - 1.0) @ h.T
    if l1_reg_w > 0:
        denominator = denominator + l1_reg_w
    if l2_reg_w > 0:
        denominator = denominator + l2_reg_w * w
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    delta = numerator / denominator
    if gamma != 1.0:
        delta = delta**gamma
    w = w * delta
    if beta < 1.0:
        w = jnp.where(w < F64_EPS, 0.0, w)

    if not update_h:
        return w, h

    # ---- H update ----
    wh = w @ h
    numerator = w.T @ _wh_pow_times_x(x, wh, beta)
    if beta == 1.0:
        w_sum = jnp.sum(w, axis=0)
        w_sum = jnp.where(w_sum == 0, 1.0, w_sum)
        denominator = jnp.broadcast_to(w_sum[:, None], h.shape)
    else:
        whd = jnp.maximum(wh, EPSILON) if beta - 1.0 < 0 else wh
        denominator = w.T @ whd ** (beta - 1.0)
    if l1_reg_h > 0:
        denominator = denominator + l1_reg_h
    if l2_reg_h > 0:
        denominator = denominator + l2_reg_h * h
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    delta = numerator / denominator
    if gamma != 1.0:
        delta = delta**gamma
    h = h * delta
    if beta <= 1.0:
        h = jnp.where(h < F64_EPS, 0.0, h)
    return w, h


class BetaState(NamedTuple):
    """Final state of a beta-MU solve (mirrors ``MUState``)."""

    w: jnp.ndarray
    h: jnp.ndarray
    n_iter: jnp.ndarray
    previous_error: jnp.ndarray
    converged: jnp.ndarray


@functools.partial(
    jax.jit,
    static_argnames=(
        "beta", "max_iter", "tol", "check_every",
        "l1_reg_w", "l2_reg_w", "l1_reg_h", "l2_reg_h", "update_h",
    ),
)
def fit_mu_beta(
    x,
    w0,
    h0,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    update_h: bool = True,
) -> BetaState:
    """Beta-MU to convergence with sklearn's exact stopping rule.

    The stopping statistic's matmuls run at
    ``jax.lax.Precision.HIGHEST`` (see :func:`beta_divergence`); the
    updates keep the platform default.
    """
    _hi = jax.lax.Precision.HIGHEST
    error_at_init = beta_divergence(
        x, w0, h0, beta, square_root=True, precision=_hi
    )

    def chunk(state: BetaState) -> BetaState:
        steps = jnp.minimum(check_every, max_iter - state.n_iter)

        def body(_, carry):
            w, h = carry
            return mu_update_beta(
                x, w, h, beta, l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h,
                update_h,
            )

        w, h = jax.lax.fori_loop(0, steps, body, (state.w, state.h))
        n_iter = state.n_iter + steps
        if tol > 0:
            error = beta_divergence(
                x, w, h, beta, square_root=True, precision=_hi
            )
            converged = (state.previous_error - error) / error_at_init < tol
            converged = jnp.logical_and(converged, n_iter % check_every == 0)
            return BetaState(w, h, n_iter, error, converged)
        return BetaState(w, h, n_iter, state.previous_error, state.converged)

    def cond(state: BetaState):
        return jnp.logical_and(state.n_iter < max_iter, ~state.converged)

    init = BetaState(
        w=jnp.asarray(w0),
        h=jnp.asarray(h0),
        n_iter=jnp.zeros((), jnp.int32),
        previous_error=error_at_init,
        converged=jnp.zeros((), bool),
    )
    return jax.lax.while_loop(cond, chunk, init)
