"""Fused batched beta-divergence MU iterations as a Pallas kernel (Triton).

Same design as :mod:`.mu_pallas`, specialized for the non-Frobenius
objectives (``beta_loss='kullback-leibler'`` / ``'itakura-saito'`` or
any float beta, sklearn ``solver='mu'``).  There is no Gram shortcut:
each half-iteration rebuilds ``WH`` and the quotient weights over the
full ``N x L`` of every trial.  The XLA path writes those to memory
and reads them back on every trip; here they stay in registers.

- W's denominator is the per-component row-sum of H (KL) or the
  ``WH^(beta-1)`` projection, H's the matching column sums with
  sklearn's ``W_sum == 0 -> 1`` guard;
- sklearn's ``gamma`` damping (``1/(2-beta)`` for ``beta < 1``,
  ``1/(beta-1)`` for ``beta > 2``) and its stability flushes (W for
  ``beta < 1``, H for ``beta <= 1``) apply;
- half-integer exponents lower to sqrt chains, the rest to
  ``exp(p*log(v))``.

Numerics match :func:`muscle_synergies_tpu.models.beta.mu_update_beta`
for every beta (same clamps, same order).  The quotient weights are
masked to zero on the padded sample rows, where ``WH`` is clamped to
epsilon and a negative power of it could overflow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..beta import F64_EPS, _gamma
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

__all__ = ["beta_mu_iterations_pallas", "kl_mu_iterations_pallas"]


def _pow(v, p: float):
    """``v ** p`` for a static exponent, cheap special cases first.

    ``v`` is strictly positive (clamped by the caller).  Half-integer
    exponents become multiply/sqrt chains; anything else lowers to
    ``exp(p * log(v))``.
    """
    if p == 0.0:
        return jnp.ones_like(v)
    if p == 1.0:
        return v
    if p == 2.0:
        return v * v
    if p == -1.0:
        return 1.0 / v
    if p == -2.0:
        inv = 1.0 / v
        return inv * inv
    if p == 0.5:
        return jnp.sqrt(v)
    if p == -0.5:
        return 1.0 / jnp.sqrt(v)
    if p == 1.5:
        return v * jnp.sqrt(v)
    if p == -1.5:
        inv = 1.0 / v
        return inv / jnp.sqrt(v)
    return jnp.exp(p * jnp.log(v))


def _num_den_weights(x_m, wh_m, beta: float):
    """Per-channel numerator/denominator weights for the MU update.

    Numerator weight ``X * WH^(beta-2)`` (WH clamped when ``beta < 2``,
    sklearn's ``_multiplicative_update_w``); denominator weight
    ``WH^(beta-1)`` (clamped when ``beta < 1``) — except beta=1 (KL),
    whose denominator is constant (factor sums, handled by the caller).

    For ``beta < 1`` both weights clamp to the *same* value, so the
    expensive subexpression — the reciprocal (Itakura-Saito), the
    square root (half-integer betas) or the logarithm (generic betas)
    — is computed once and reused.  Every shared form is bitwise
    identical to evaluating :func:`_pow` twice (same inputs, same
    operation order), so kernel-vs-XLA parity is unaffected.
    """
    wh_num = jnp.maximum(wh_m, EPSILON) if beta < 2.0 else wh_m
    if beta == 1.0:
        return x_m * _pow(wh_num, -1.0), None
    if beta >= 1.0:
        # numerator and denominator clamp differently: no sharing
        return x_m * _pow(wh_num, beta - 2.0), _pow(wh_m, beta - 1.0)
    whc = wh_num  # beta < 1: one clamp serves both weights
    if beta == 0.0:
        # Itakura-Saito: one reciprocal serves WH^-2 and WH^-1
        inv = 1.0 / whc
        return x_m * (inv * inv), inv
    if beta == 0.5:
        # WH^-1.5 = (1/WH)/sqrt(WH) and WH^-0.5 = 1/sqrt(WH): share sqrt
        s = jnp.sqrt(whc)
        inv = 1.0 / whc
        return x_m * (inv / s), 1.0 / s
    if beta == -0.5:
        # WH^-2.5 lowers generically, WH^-1.5 as a sqrt chain; no
        # bitwise-identical shared form exists — keep _pow's forms
        return x_m * _pow(whc, -2.5), _pow(whc, -1.5)
    if beta - 2.0 in (0.0, 1.0, 2.0, -1.0, -2.0, 0.5, -0.5, 1.5, -1.5) or (
        beta - 1.0
    ) in (0.0, 1.0, 2.0, -1.0, -2.0, 0.5, -0.5, 1.5, -1.5):
        # one exponent is a cheap special case: sharing a log would
        # change its bits, so evaluate independently
        return x_m * _pow(whc, beta - 2.0), _pow(whc, beta - 1.0)
    # generic beta < 1: both exponents lower to exp(p * log(WH)) —
    # share the log (bitwise identical: same input, same op)
    lg = jnp.log(whc)
    return x_m * jnp.exp((beta - 2.0) * lg), jnp.exp((beta - 1.0) * lg)


def _damp(delta, gamma: float):
    """sklearn's ``delta ** gamma`` exponent damping.

    ``delta >= 0``; ``delta == 0`` maps to 0 through the IEEE
    ``exp(gamma * -inf) = 0`` identity on the generic path.
    """
    if gamma == 1.0:
        return delta
    if gamma == 0.5:
        return jnp.sqrt(delta)
    return jnp.exp(gamma * jnp.log(delta))


def _weights(x, w, h, beta: float, valid):
    """Per-channel quotient weights of the current ``WH``."""
    k = len(w)
    num_w, den_w = [], []
    for m, xm in enumerate(x):
        wh = add_all([w[j] * col(h[j][m]) for j in range(k)])
        a, bden = _num_den_weights(xm, wh, beta)
        if valid is not None:
            a = jnp.where(valid, a, 0.0)
            bden = None if bden is None else jnp.where(valid, bden, 0.0)
        num_w.append(a)
        den_w.append(bden)
    return num_w, den_w


def _beta_step(x, w, h, beta: float, valid):
    """One beta-MU update (W then H, sklearn's order) on list layouts."""
    k, l = len(w), len(x)
    gamma = _gamma(beta)

    # ---- W update ----
    num_w, den_w = _weights(x, w, h, beta, valid)
    w_new = []
    for i in range(k):
        num = add_all([num_w[m] * col(h[i][m]) for m in range(l)])
        if beta == 1.0:
            h_sum = add_all([h[i][m] for m in range(l)])
            den = col(jnp.where(h_sum == 0, EPSILON, h_sum))
        else:
            den = add_all([den_w[m] * col(h[i][m]) for m in range(l)])
            den = jnp.where(den == 0, EPSILON, den)
        val = w[i] * _damp(num / den, gamma)
        if beta < 1.0:
            val = jnp.where(val < F64_EPS, 0.0, val)
        w_new.append(val)
    w = w_new

    # ---- H update with the fresh W ----
    num_w, den_w = _weights(x, w, h, beta, valid)
    h_new = []
    for i in range(k):
        if beta == 1.0:
            w_sum = rsum(w[i])
            w_sum = jnp.where(w_sum == 0, 1.0, w_sum)
        row = []
        for m in range(l):
            num = rsum(w[i] * num_w[m])
            if beta == 1.0:
                delta = num / w_sum
            else:
                den = rsum(w[i] * den_w[m])
                delta = num / jnp.where(den == 0, EPSILON, den)
            val = h[i][m] * _damp(delta, gamma)
            if beta <= 1.0:
                val = jnp.where(val < F64_EPS, 0.0, val)
            row.append(val)
        h_new.append(row)
    return w, h_new


def _beta_kernel(x_ref, w_ref, h_ref, w_out, h_out, *, n_iters, k, l, n,
                 beta):
    x = load_rows(x_ref, l)
    n_pad = x[0].shape[1]
    valid = None
    if n < n_pad:
        valid = jax.lax.broadcasted_iota(jnp.int32, x[0].shape, 1) < n

    def body(_, carry):
        return _beta_step(x, *carry, beta=beta, valid=valid)

    w, h = jax.lax.fori_loop(
        0, n_iters, body, (load_rows(w_ref, k), load_h(h_ref, k, l))
    )
    store_rows(w_out, w)
    store_h(h_out, h)


@functools.partial(
    jax.jit, static_argnames=("n_iters", "beta", "interpret")
)
def beta_mu_iterations_pallas(xs, w, h, n_iters: int, beta: float = 1.0,
                              interpret: bool = False):
    """Run ``n_iters`` beta-MU iterations on a ``(B, N, L)`` batch.

    Drop-in for ``vmap(mu_update_beta(..., beta=beta))`` iterated
    ``n_iters`` times, for any float ``beta`` (1.0 = KL, 0.0 =
    Itakura-Saito); any batch size and trial length.
    """
    beta = float(beta)
    _, n, l = xs.shape
    k = w.shape[-1]
    xt, wt = pack(xs, w)
    kernel = functools.partial(
        _beta_kernel, n_iters=n_iters, k=k, l=l, n=n, beta=beta
    )
    wt, h = call(
        kernel, (xt, wt, h),
        [jax.ShapeDtypeStruct(wt.shape, w.dtype),
         jax.ShapeDtypeStruct(h.shape, h.dtype)],
        name="beta_mu_iterations", interpret=interpret,
    )
    return unpack(wt, n), h


def kl_mu_iterations_pallas(xs, w, h, n_iters: int, interpret: bool = False):
    """KL specialization of :func:`beta_mu_iterations_pallas`."""
    return beta_mu_iterations_pallas(
        xs, w, h, n_iters, beta=1.0, interpret=interpret
    )
