"""Batched NMF: whole gait datasets factorize in one device computation.

The reference loops over trials and ranks in Python, one sklearn fit at
a time (reference analysis.py:909-913).  Here the batch dimensions are
JAX axes:

- :func:`fit_mu_batch` / :func:`fit_cd_batch` vmap the fused solvers
  over a ``(B, N, L)`` stack of trials.  Under vmap the convergence
  ``while_loop`` keeps iterating until every trial in the batch is
  done while already-converged trials are frozen, so per-trial stopping
  matches the unbatched solver exactly.
- Ragged trials are zero-padded: rows of X beyond a trial's true length
  are zero and the matching rows of W are initialized to zero, which
  the multiplicative updates preserve — the padded region contributes
  exactly nothing to either factor or loss.
- :func:`rank_sweep_batch` evaluates a whole range of ranks in one
  vmapped computation by zero-padding factors to the maximum rank:
  zeroed trailing components stay zero under both MU and CD updates,
  so each sweep entry is bit-equivalent to an independent fit at that
  rank.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.platform import resolve_impl
from .hals import CDState, fit_cd
from .init import initialize_nmf
from .mu import MUState, fit_mu, full_precision

__all__ = [
    "pad_and_stack",
    "init_batch",
    "mu_update_batch",
    "mu_iterations_batch",
    "fit_mu_batch",
    "fit_mu_beta_batch",
    "fit_cd_batch",
    "rank_sweep_batch",
    "vaf_batch",
]


def pad_and_stack(
    trials: Sequence[np.ndarray], pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged ``(N_i, L)`` trials into ``(B, N_max, L)`` + mask.

    Returns:
        ``(batch, mask)`` where ``mask[b, n]`` is 1.0 for real samples
        and 0.0 for padding.  Padded cells are zero.
    """
    lengths = [t.shape[0] for t in trials]
    n_max = pad_to if pad_to is not None else max(lengths)
    if any(n > n_max for n in lengths):
        raise ValueError(f"pad_to={n_max} is smaller than the longest trial")
    l = trials[0].shape[1]
    batch = np.zeros((len(trials), n_max, l), dtype=np.asarray(trials[0]).dtype)
    mask = np.zeros((len(trials), n_max), dtype=batch.dtype)
    for b, t in enumerate(trials):
        if t.shape[1] != l:
            raise ValueError("all trials must share the channel count")
        batch[b, : t.shape[0]] = t
        mask[b, : t.shape[0]] = 1.0
    return batch, mask


def init_batch(
    xs: jnp.ndarray,
    n_components: int,
    init: Optional[str] = None,
    mask: Optional[jnp.ndarray] = None,
    seed: int = 0,
):
    """Vmapped factor initialization over a ``(B, N, L)`` batch.

    With a padding ``mask``, the padded rows of every ``W`` are zeroed
    so they stay zero through the multiplicative updates.
    """
    w, h = jax.vmap(
        lambda x: initialize_nmf(x, n_components, init=init, seed=seed)
    )(xs)
    if mask is not None:
        w = w * mask[..., None]
    return w, h


@full_precision
def mu_update_batch(
    xs: jnp.ndarray, w: jnp.ndarray, h: jnp.ndarray, inner_iter: int = 1
):
    """One MU iteration over a ``(B, N, L)`` batch (batched matmuls).

    The per-trial matmuls contract over N or L with the batch as the
    leading batching dimension, so XLA lowers them as batched GEMMs and
    fuses the element-wise multiply/divide chain.
    ``inner_iter > 1`` repeats each factor's update reusing the fixed
    factor's cross products, matching
    :func:`muscle_synergies_tpu.models.mu.mu_update` exactly.
    """
    from .mu import EPSILON

    ht = jnp.swapaxes(h, -1, -2)
    xht = xs @ ht
    hht = h @ ht
    for _ in range(inner_iter):
        denominator = w @ hht
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        w = w * (xht / denominator)

    wt = jnp.swapaxes(w, -1, -2)
    wtx = wt @ xs
    wtw = wt @ w
    for _ in range(inner_iter):
        denominator = wtw @ h
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        h = h * (wtx / denominator)
    return w, h


@functools.partial(jax.jit, static_argnames=("n_iters", "inner_iter"))
def _mu_iterations_xla(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    n_iters: int,
    inner_iter: int = 1,
):
    def body(_, wh):
        return mu_update_batch(xs, *wh, inner_iter=inner_iter)

    return jax.lax.fori_loop(0, n_iters, body, (w, h))


def mu_iterations_batch(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    n_iters: int,
    impl: str = "xla",
    inner_iter: int = 1,
    interpret: bool = False,
):
    """Run ``n_iters`` fused MU iterations (no convergence checks).

    The throughput primitive: one compiled program performs every
    iteration on device, so timing measures the update itself, not
    dispatch overhead.

    Args:
        impl: ``"xla"`` (batched GEMMs), ``"pallas"`` (the Triton
            kernel, :mod:`muscle_synergies_tpu.models.kernels`) or
            ``"auto"``; see
            :func:`muscle_synergies_tpu.utils.platform.resolve_impl`.
        interpret: run the kernel in Pallas' interpreter (tests only).
    """
    if resolve_impl(
        impl, "mu", rank=w.shape[-1], interpret=interpret
    ) == "pallas":
        from .kernels import mu_iterations_pallas

        return mu_iterations_pallas(
            xs, w, h, n_iters, inner_iter=inner_iter, interpret=interpret
        )
    return _mu_iterations_xla(xs, w, h, n_iters, inner_iter=inner_iter)


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "tol", "check_every", "inner_iter",
                     "l1_reg_w", "l2_reg_w", "l1_reg_h", "l2_reg_h"),
)
def _fit_mu_batch_xla(
    xs, w0, h0, max_iter, tol, check_every, inner_iter=1,
    l1_reg_w=0.0, l2_reg_w=0.0, l1_reg_h=0.0, l2_reg_h=0.0,
) -> MUState:
    return jax.vmap(
        lambda x, w, h: fit_mu(
            x, w, h, max_iter=max_iter, tol=tol, check_every=check_every,
            inner_iter=inner_iter, l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
            l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
        )
    )(xs, w0, h0)


def fit_mu_batch(
    xs: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    impl: str = "xla",
    inner_iter: int = 1,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    interpret: bool = False,
) -> MUState:
    """MU-NMF over a ``(B, N, L)`` batch with per-trial convergence.

    ``impl="pallas"`` routes through the fused Triton solver
    (:func:`muscle_synergies_tpu.models.kernels.fit_mu_pallas`): same
    stopping semantics, the whole solve in one launch.  The L1/L2
    penalties (sklearn's pre-scaled regularizers) run on the XLA path
    only.
    """
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    penalized = any(r != 0.0 for r in regs)
    if resolve_impl(
        impl, "mu", rank=w0.shape[-1], penalized=penalized,
        interpret=interpret,
    ) == "pallas":
        from .kernels import fit_mu_pallas

        w, h, n_iter, prev_err, converged = fit_mu_pallas(
            xs, w0, h0, max_iter=max_iter, tol=tol,
            check_every=check_every, inner_iter=inner_iter,
            interpret=interpret,
        )
        return MUState(w, h, n_iter, prev_err, converged)
    return _fit_mu_batch_xla(
        xs, w0, h0, max_iter, tol, check_every, inner_iter, *regs
    )


def fit_mu_beta_batch(
    xs: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    impl: str = "xla",
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    interpret: bool = False,
):
    """Beta-divergence MU over a ``(B, N, L)`` batch.

    ``impl="xla"`` vmaps
    :func:`muscle_synergies_tpu.models.beta.fit_mu_beta`; the batched
    ``while_loop`` freezes converged trials (vmap keeps each element's
    old carry once its own cond is false), so per-trial stopping
    matches the unbatched solver exactly.  ``impl="pallas"`` (any
    float ``beta``) drives the Triton
    :func:`muscle_synergies_tpu.models.kernels.beta_mu_iterations_pallas`
    in ``check_every``-iteration chunks with the same per-trial
    stopping semantics.
    """
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    penalized = any(r != 0.0 for r in regs)
    if resolve_impl(
        impl, "beta", rank=w0.shape[-1], penalized=penalized,
        interpret=interpret,
    ) == "pallas":
        return _fit_beta_batch_pallas(
            xs, w0, h0, float(beta), max_iter, float(tol), check_every,
            interpret=interpret,
        )
    from .beta import fit_mu_beta

    return jax.vmap(
        lambda x, w, h: fit_mu_beta(
            x, w, h, beta=beta, max_iter=max_iter, tol=tol,
            check_every=check_every, l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
            l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
        )
    )(xs, w0, h0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "beta", "max_iter", "tol", "check_every", "interpret",
    ),
)
def _fit_beta_batch_pallas(
    xs, w0, h0, beta, max_iter, tol, check_every, interpret=False
):
    """Beta fit driven by the Pallas kernel in convergence-checked chunks.

    The kernel runs ``check_every`` iterations per dispatch; converged
    trials' updates are discarded (select on the convergence mask),
    which is equivalent to freezing them.  Divergence checks happen at
    exact multiples of ``check_every`` like sklearn; a static tail
    chunk covers ``max_iter % check_every`` without a check.

    The stopping statistic is computed at
    ``jax.lax.Precision.HIGHEST``, like the XLA fit's: a default-
    precision matmul may round through reduced-precision passes, and
    noise in the KL log terms moves the stopping checkpoint.  The
    (N, k) @ (k, L) check matmul is negligible next to ``check_every``
    kernel iterations.
    """
    from .beta import BetaState, beta_divergence
    from .kernels import beta_mu_iterations_pallas

    div = jax.vmap(
        lambda x, w, h: beta_divergence(
            x, w, h, beta, precision=jax.lax.Precision.HIGHEST
        )
    )
    err0 = div(xs, w0, h0)
    n_full = max_iter // check_every
    tail = max_iter % check_every

    def chunk(state):
        w_new, h_new = beta_mu_iterations_pallas(
            xs, state.w, state.h, check_every, beta=beta,
            interpret=interpret,
        )
        keep = state.converged[:, None, None]
        w = jnp.where(keep, state.w, w_new)
        h = jnp.where(keep, state.h, h_new)
        n_iter = state.n_iter + jnp.where(state.converged, 0, check_every)
        if tol > 0:
            err = div(xs, w, h)
            newly = (state.previous_error - err) / err0 < tol
            converged = jnp.logical_or(state.converged, newly)
            prev = jnp.where(state.converged, state.previous_error, err)
            return BetaState(w, h, n_iter, prev, converged)
        return BetaState(w, h, n_iter, state.previous_error, state.converged)

    def cond(state):
        return jnp.logical_and(
            jnp.max(state.n_iter) < n_full * check_every,
            ~jnp.all(state.converged),
        )

    b = xs.shape[0]
    state = BetaState(
        w=jnp.asarray(w0),
        h=jnp.asarray(h0),
        n_iter=jnp.zeros((b,), jnp.int32),
        previous_error=err0,
        converged=jnp.zeros((b,), bool),
    )
    state = jax.lax.while_loop(cond, chunk, state)

    if tail:
        w_new, h_new = beta_mu_iterations_pallas(
            xs, state.w, state.h, tail, beta=beta, interpret=interpret,
        )
        keep = state.converged[:, None, None]
        w = jnp.where(keep, state.w, w_new)
        h = jnp.where(keep, state.h, h_new)
        prev = state.previous_error
        if tol > 0:
            # match the XLA path (fit_mu_beta), whose tail chunk stores
            # the divergence at max_iter for still-running trials
            err = div(xs, w, h)
            prev = jnp.where(state.converged, prev, err)
        state = BetaState(
            w,
            h,
            state.n_iter + jnp.where(state.converged, 0, tail),
            prev,
            state.converged,
        )
    return state


@functools.partial(jax.jit, static_argnames=("n_iters",))
def _cd_iterations_xla(xs, w, h, n_iters):
    from .hals import cd_pass

    def one_iter(x, w, h):
        w, _ = cd_pass(x, w, jnp.swapaxes(h, -1, -2))
        ht, _ = cd_pass(jnp.swapaxes(x, -1, -2), jnp.swapaxes(h, -1, -2), w)
        return w, jnp.swapaxes(ht, -1, -2)

    def body(_, wh):
        return jax.vmap(one_iter)(xs, *wh)

    return jax.lax.fori_loop(0, n_iters, body, (w, h))


def cd_iterations_batch(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    n_iters: int,
    impl: str = "xla",
    interpret: bool = False,
):
    """Run ``n_iters`` CD/HALS outer iterations (no convergence checks).

    The coordinate-descent counterpart of :func:`mu_iterations_batch`
    — the fixed-iteration throughput primitive behind ``bench.py
    --solver cd``.  One iteration is a cyclic pass over W's components
    then H's, sklearn's ``shuffle=False`` order
    (:func:`muscle_synergies_tpu.models.hals.cd_pass`), so iterates
    match :func:`fit_cd_batch`'s up to float reordering.
    """
    if resolve_impl(
        impl, "cd", rank=w.shape[-1], interpret=interpret
    ) == "pallas":
        from .kernels import cd_iterations_pallas

        return cd_iterations_pallas(xs, w, h, n_iters, interpret=interpret)
    return _cd_iterations_xla(xs, w, h, n_iters)


@functools.partial(jax.jit, static_argnames=("n_iters", "beta"))
def _beta_iterations_xla(xs, w, h, n_iters, beta):
    from .beta import mu_update_beta

    def body(_, wh):
        return jax.vmap(
            lambda x, w, h: mu_update_beta(x, w, h, beta=beta)
        )(xs, *wh)

    return jax.lax.fori_loop(0, n_iters, body, (w, h))


def beta_mu_iterations_batch(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    n_iters: int,
    beta: float = 1.0,
    impl: str = "xla",
    interpret: bool = False,
):
    """Run ``n_iters`` beta-MU iterations (no convergence checks).

    The beta-divergence counterpart of :func:`mu_iterations_batch` —
    the fixed-iteration throughput primitive behind ``bench.py
    --solver {kl,is}`` and any float ``beta``.
    """
    if resolve_impl(
        impl, "beta", rank=w.shape[-1], interpret=interpret
    ) == "pallas":
        from .kernels import beta_mu_iterations_pallas

        return beta_mu_iterations_pallas(
            xs, w, h, n_iters, beta=beta, interpret=interpret
        )
    return _beta_iterations_xla(xs, w, h, n_iters, beta)


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "tol", "l1_reg_w", "l2_reg_w", "l1_reg_h",
                     "l2_reg_h"),
)
def _fit_cd_batch_xla(
    xs, w0, h0, max_iter, tol,
    l1_reg_w=0.0, l2_reg_w=0.0, l1_reg_h=0.0, l2_reg_h=0.0,
) -> CDState:
    return jax.vmap(
        lambda x, w, h: fit_cd(
            x, w, h, max_iter=max_iter, tol=tol, l1_reg_w=l1_reg_w,
            l2_reg_w=l2_reg_w, l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
        )
    )(xs, w0, h0)


def fit_cd_batch(
    xs: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    impl: str = "xla",
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    interpret: bool = False,
) -> CDState:
    """Coordinate-descent NMF over a ``(B, N, L)`` batch.

    ``impl="pallas"`` routes through the fused Triton solver
    (:func:`muscle_synergies_tpu.models.kernels.fit_cd_pallas`):
    sklearn's violation-based stopping per trial, the whole solve one
    launch.  The L1/L2 penalties run on the XLA path only.
    """
    regs = (l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h)
    penalized = any(r != 0.0 for r in regs)
    if resolve_impl(
        impl, "cd", rank=w0.shape[-1], penalized=penalized,
        interpret=interpret,
    ) == "pallas":
        from .kernels import fit_cd_pallas

        w, h, n_iter, viol_init, converged = fit_cd_pallas(
            xs, w0, h0, max_iter=max_iter, tol=tol, interpret=interpret
        )
        return CDState(
            w, jnp.swapaxes(h, -1, -2), n_iter, viol_init, converged
        )
    return _fit_cd_batch_xla(xs, w0, h0, max_iter, tol, *regs)


def _pad_rank(w: jnp.ndarray, h: jnp.ndarray, k: int, k_max: int):
    """Zero-pad rank-``k`` factors to ``k_max`` components."""
    w_pad = jnp.zeros((w.shape[0], k_max - k), w.dtype)
    h_pad = jnp.zeros((k_max - k, h.shape[1]), h.dtype)
    return jnp.concatenate([w, w_pad], axis=1), jnp.concatenate([h, h_pad], axis=0)


def rank_sweep_batch(
    x: jnp.ndarray,
    ranks: Sequence[int],
    init: Optional[str] = None,
    solver: str = "mu",
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    svd_method: str = "exact",
    beta_loss="frobenius",
    inner_iter: int = 1,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
):
    """Factorize one trial at several ranks in a single vmapped fit.

    Factors for every rank are zero-padded to ``max(ranks)``; the
    padded components remain exactly zero under all solvers — the
    Frobenius MU/CD Gram guards and the beta-MU zero numerators alike,
    with or without the L1/L2 penalties (a padded component's update
    numerator is identically zero, and CD's Newton step projects the
    L1 pull to zero) — so entry ``i`` equals an independent
    rank-``ranks[i]`` fit.  ``beta_loss != 'frobenius'`` requires
    ``solver='mu'``; so does ``inner_iter > 1``.

    Returns:
        ``(states, vafs)``: the stacked solver states (leading axis =
        rank index; slice each rank's factors as
        ``w[i][:, :ranks[i]]``) and the overall VAF per rank.
    """
    k_max = max(ranks)
    w_stack, h_stack = [], []
    for k in ranks:
        w0, h0 = initialize_nmf(
            x, k, init=init, seed=seed, svd_method=svd_method
        )
        w0p, h0p = _pad_rank(
            w0.astype(x.dtype), h0.astype(x.dtype), k, k_max
        )
        w_stack.append(w0p)
        h_stack.append(h0p)
    w0s = jnp.stack(w_stack)
    h0s = jnp.stack(h_stack)
    xs = jnp.broadcast_to(x, (len(ranks),) + x.shape)

    from .beta import beta_loss_to_float

    beta = beta_loss_to_float(beta_loss)
    if beta != 2.0 and solver != "mu":
        raise ValueError(
            f"beta_loss={beta_loss!r} requires solver='mu', got {solver!r}"
        )
    if inner_iter != 1 and (solver != "mu" or beta != 2.0):
        raise ValueError(
            "inner_iter > 1 is only available for the Frobenius MU solver"
        )
    regs = dict(l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
                l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h)
    if beta != 2.0:
        states = fit_mu_beta_batch(
            xs, w0s, h0s, beta=beta, max_iter=max_iter, tol=tol, **regs
        )
        w_final, h_final = states.w, states.h
    elif solver == "mu":
        states = fit_mu_batch(
            xs, w0s, h0s, max_iter=max_iter, tol=tol,
            inner_iter=inner_iter, **regs,
        )
        w_final, h_final = states.w, states.h
    elif solver == "cd":
        states = fit_cd_batch(xs, w0s, h0s, max_iter=max_iter, tol=tol, **regs)
        w_final, h_final = states.w, jnp.swapaxes(states.ht, -1, -2)
    else:
        raise ValueError(f"unknown solver: {solver!r}")

    vafs = jax.vmap(lambda w, h: _vaf_overall(x, w, h))(w_final, h_final)
    return states, vafs


@full_precision
def _vaf_overall(x, w, h):
    err = x - w @ h
    return 1.0 - jnp.sum(err * err) / jnp.sum(x * x)


@full_precision
def vaf_batch(xs: jnp.ndarray, ws: jnp.ndarray, hs: jnp.ndarray):
    """Overall and per-channel VAF for a batch of factorizations.

    Returns:
        ``(overall, per_channel)`` with shapes ``(B,)`` and ``(B, L)``.
    """

    def one(x, w, h):
        err = x - w @ h
        overall = 1.0 - jnp.sum(err * err) / jnp.sum(x * x)
        per = 1.0 - jnp.sum(err * err, axis=0) / jnp.sum(x * x, axis=0)
        return overall, per

    return jax.vmap(one)(xs, ws, hs)
