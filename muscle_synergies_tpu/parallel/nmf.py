"""Mesh-sharded NMF: data-parallel trials x time-sharded samples.

The sharded multiplicative update is the sequence-parallel analog of
the solver in :mod:`muscle_synergies_tpu.models.mu` and is *exact*, not
approximate (SURVEY §5 "long-context" requirement):

- ``X`` and ``W`` are sharded ``(data, time)`` — each device owns a
  slice of the trial batch and a contiguous block of each trial's
  samples.  ``H`` is replicated within a time group.
- The W update is embarrassingly local: its numerator ``X Ht`` and
  denominator ``W (H Ht)`` involve only the device's own sample rows.
- The H update needs the time-reduced Grams ``Wt X`` and ``Wt W``;
  each device contributes its local partial product and a ``psum``
  over the ``time`` axis completes them — the NMF equivalent of
  sequence-parallel attention's collective.
- Convergence (Frobenius error) is likewise a time-``psum`` of local
  squared residuals, so every device in a time group sees the same
  stopping decision; different data shards may stop at different
  iteration counts independently.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.mu import EPSILON, MUState, full_precision
from .collectives import axis_sum, mark_varying, time_sum
from .mesh import DATA_AXIS, MODEL_AXIS, TIME_AXIS

__all__ = [
    "sharded_mu_step",
    "sharded_fit_mu",
    "sharded_fit_beta",
    "sharded_fit_kl",
    "sharded_fit_cd",
    "sharded_fit_mu_tp",
]


@full_precision
def _local_mu_step(
    x, w, h, axis_name: str,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
    inner_iter: int = 1,
):
    """One MU iteration on local shards; Grams psum'd over ``axis_name``.

    Shapes (local): x ``(b, n_loc, L)``, w ``(b, n_loc, k)``,
    h ``(b, k, L)`` (replicated over the time group).  Penalties are
    the caller's pre-scaled values (sklearn's dimension scaling uses
    the GLOBAL shape) and enter the denominators exactly as in
    :func:`muscle_synergies_tpu.models.mu.mu_update` — fully local,
    since ``W``'s penalty touches only this device's rows and ``H`` is
    replicated within a time group.  ``inner_iter > 1`` repeats each
    factor's update reusing the cross products (the accelerated MU of
    the local solver), costing no extra collectives for W and none for
    H beyond the one Gram psum pair.
    """
    ht = jnp.swapaxes(h, -1, -2)
    # --- W updates: fully local; X Ht / H Ht fixed while H is ---
    xht = x @ ht
    hht = h @ ht
    for _ in range(inner_iter):
        denominator = w @ hht
        if l1_reg_w > 0:
            denominator = denominator + l1_reg_w
        if l2_reg_w > 0:
            denominator = denominator + l2_reg_w * w
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        w = w * (xht / denominator)

    # --- H updates: time-reduced Grams, fixed while W is ---
    wt = jnp.swapaxes(w, -1, -2)
    wtx = time_sum(wt @ x, axis_name)
    wtw = time_sum(wt @ w, axis_name)
    for _ in range(inner_iter):
        denominator = wtw @ h
        if l1_reg_h > 0:
            denominator = denominator + l1_reg_h
        if l2_reg_h > 0:
            denominator = denominator + l2_reg_h * h
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        h = h * (wtx / denominator)
    return w, h


def _local_error(x, w, h, axis_name: str):
    """Per-trial Frobenius error with the sum-of-squares psum'd.

    The reconstruction runs at ``Precision.HIGHEST``: this is a
    stopping statistic, and a reduced-precision default product flips
    near-threshold relative-improvement decisions (same discipline as
    ``models.mu.fit_mu``).
    """
    diff = x - jnp.matmul(w, h, precision=jax.lax.Precision.HIGHEST)
    sq = time_sum(jnp.sum(diff * diff, axis=(-1, -2)), axis_name)
    return jnp.sqrt(sq)


def _convergence_driver(
    xb, wb, hb, local_step, local_error, axis_name, state_cls,
    max_iter: int, tol: float, check_every: int,
):
    """Shared sklearn-stopping loop for the sharded solvers.

    Runs inside ``shard_map``: chunks of ``check_every`` iterations
    with converged trials frozen, the criterion evaluated at exact
    ``check_every`` multiples, and — like the local solvers' static
    branch — no criterion at all when ``tol == 0`` (run to
    ``max_iter``, ``previous_error`` stays the initial error).
    ``state_cls`` is any NamedTuple whose first two fields are the two
    factors (any per-trial rank; e.g. ``(w, h, ...)`` or the
    convolutive ``(c, s, ...)``) followed by
    ``(n_iter, previous_error, converged)``.
    """
    b = xb.shape[0]
    error_at_init = local_error(xb, wb, hb, axis_name)

    def chunk(state):
        steps = jnp.minimum(check_every, max_iter - jnp.max(state.n_iter))

        def body(_, carry):
            w, h = carry
            w_new, h_new = local_step(xb, w, h, axis_name)
            keep_w = state.converged.reshape((-1,) + (1,) * (w.ndim - 1))
            keep_h = state.converged.reshape((-1,) + (1,) * (h.ndim - 1))
            return (
                jnp.where(keep_w, w, w_new),
                jnp.where(keep_h, h, h_new),
            )

        w, h = jax.lax.fori_loop(0, steps, body, (state[0], state[1]))
        n_iter = jnp.where(state.converged, state.n_iter, state.n_iter + steps)
        if tol > 0:
            error = local_error(xb, w, h, axis_name)
            at_checkpoint = n_iter % check_every == 0
            newly = jnp.logical_and(
                (state.previous_error - error) / error_at_init < tol,
                at_checkpoint,
            )
            converged = jnp.logical_or(state.converged, newly)
            previous_error = jnp.where(
                state.converged, state.previous_error, error
            )
            return state_cls(w, h, n_iter, previous_error, converged)
        return state_cls(w, h, n_iter, state.previous_error, state.converged)

    def cond(state):
        return jnp.logical_and(
            jnp.max(state.n_iter) < max_iter,
            ~jnp.all(state.converged),
        )

    # Freshly-created carry entries must be marked as varying over the
    # data axis (their loop-carried updates depend on this shard's
    # trials), or shard_map's varying-axis check rejects the while_loop.
    init = state_cls(
        wb,
        hb,
        mark_varying(jnp.zeros((b,), jnp.int32), DATA_AXIS),
        error_at_init,
        mark_varying(jnp.zeros((b,), bool), DATA_AXIS),
    )
    return jax.lax.while_loop(cond, chunk, init)


def sharded_mu_step(
    x: jnp.ndarray,
    w: jnp.ndarray,
    h: jnp.ndarray,
    mesh: Mesh,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One sharded MU iteration over a ``(data, time)`` mesh.

    Args:
        x: ``(B, N, L)`` batch, sharded ``P(data, time, None)``.
        w: ``(B, N, k)`` factors, sharded like ``x``.
        h: ``(B, k, L)`` factors, sharded ``P(data, None, None)``.

    Returns:
        ``(w, h, error)`` with ``error`` the per-trial Frobenius error
        after the update.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None),
        ),
        out_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS),
        ),
    )
    def step(xb, wb, hb):
        wb, hb = _local_mu_step(xb, wb, hb, TIME_AXIS)
        err = _local_error(xb, wb, hb, TIME_AXIS)
        return wb, hb, err

    return step(x, w, h)


def sharded_fit_mu(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
) -> MUState:
    """Run MU-NMF to convergence on a ``(data, time)`` mesh.

    Semantics match :func:`muscle_synergies_tpu.models.mu.fit_mu`
    (sklearn's stopping rule, checked every ``check_every``
    iterations; the same L1/L2 denominator penalties — pass pre-scaled
    values computed from the GLOBAL shape — and the same accelerated-MU
    ``inner_iter``), with all time reductions as ``psum`` collectives.
    The convergence loop runs *inside* ``shard_map``, so the whole fit
    is one compiled program per device with zero host round-trips.
    """
    local_step = functools.partial(
        _local_mu_step,
        l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
        l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
        inner_iter=inner_iter,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None),
        ),
        out_specs=MUState(
            w=P(DATA_AXIS, TIME_AXIS, None),
            h=P(DATA_AXIS, None, None),
            n_iter=P(DATA_AXIS),
            previous_error=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, wb, hb):
        return _convergence_driver(
            xb, wb, hb, local_step, _local_error, TIME_AXIS, MUState,
            max_iter, tol, check_every,
        )

    return fit(x, w0, h0)


@full_precision
def _local_beta_step(
    x, w, h, axis_name: str, beta: float = 1.0,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
):
    """One beta-MU iteration on local time shards (any float beta).

    The W update is fully local: its numerator ``(X*(WH)^(b-2)) Ht``
    and denominator — H row-sums for KL, ``(WH)^(b-1) Ht`` otherwise —
    touch only this device's sample rows.  The H update needs two time
    reductions, completed by ``psum``: ``Wt (X*(WH)^(b-2))`` and the
    denominator projection (W column sums for KL, ``Wt (WH)^(b-1)``
    otherwise).  Matches
    :func:`muscle_synergies_tpu.models.beta.mu_update_beta` exactly
    (same clamps, gamma damping, guards and stability flushes).
    """
    from ..models.beta import F64_EPS, _gamma, _wh_pow_times_x

    gamma = _gamma(beta)

    def damp(delta):
        return delta if gamma == 1.0 else delta**gamma

    ht = jnp.swapaxes(h, -1, -2)

    # --- W update: fully local (incl. the penalties: W's rows live
    # with their samples and H is replicated in the time group) ---
    wh = w @ h
    numerator = _wh_pow_times_x(x, wh, beta) @ ht
    if beta == 1.0:
        # (b, k) H row-sums, replicated over time; the zero guard is
        # applied AFTER the penalties, exactly like the local solver
        denominator = jnp.broadcast_to(
            jnp.sum(h, axis=-1)[:, None, :], w.shape
        )
    else:
        whd = jnp.maximum(wh, EPSILON) if beta - 1.0 < 0 else wh
        denominator = whd ** (beta - 1.0) @ ht
    if l1_reg_w > 0:
        denominator = denominator + l1_reg_w
    if l2_reg_w > 0:
        denominator = denominator + l2_reg_w * w
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    w = w * damp(numerator / denominator)
    if beta < 1.0:
        w = jnp.where(w < F64_EPS, 0.0, w)

    # --- H update: time-reduced projections ---
    wh = w @ h
    wt = jnp.swapaxes(w, -1, -2)
    numerator = time_sum(wt @ _wh_pow_times_x(x, wh, beta), axis_name)
    if beta == 1.0:
        w_sum = time_sum(jnp.sum(w, axis=-2), axis_name)  # (b, k)
        w_sum = jnp.where(w_sum == 0, 1.0, w_sum)
        denominator = jnp.broadcast_to(w_sum[:, :, None], h.shape)
    else:
        whd = jnp.maximum(wh, EPSILON) if beta - 1.0 < 0 else wh
        denominator = time_sum(wt @ whd ** (beta - 1.0), axis_name)
    if l1_reg_h > 0:
        denominator = denominator + l1_reg_h
    if l2_reg_h > 0:
        denominator = denominator + l2_reg_h * h
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    h = h * damp(numerator / denominator)
    if beta <= 1.0:
        h = jnp.where(h < F64_EPS, 0.0, h)
    return w, h


def _local_beta_error(x, w, h, axis_name: str, beta: float = 1.0):
    """Per-trial sqrt(2*divergence) with local partial sums psum'd.

    Equals :func:`muscle_synergies_tpu.models.beta.beta_divergence`
    (``square_root=True``) on the gathered data: every data-dependent
    term — including the sklearn quirk that the Itakura-Saito constant
    counts *all* entries, masked or not — is a local sum completed by
    one time reduction.  The reconstruction runs at
    ``Precision.HIGHEST`` (stopping-statistic discipline, see
    :func:`_local_error`).
    """
    wh = jnp.matmul(w, h, precision=jax.lax.Precision.HIGHEST)
    if beta == 2.0:
        # beta_divergence's dedicated Frobenius branch: unmasked,
        # unclamped sum((x - wh)^2)/2, then sqrt(2*res)
        local = jnp.sum((x - wh) ** 2, axis=(-1, -2)) / 2.0
        res = time_sum(local, axis_name)
        return jnp.sqrt(2.0 * jnp.maximum(res, 0.0))
    whc = jnp.maximum(wh, EPSILON)
    mask = x > EPSILON
    div = jnp.where(mask, x / whc, 1.0)
    if beta == 1.0:
        # the WH total uses the reference's colsum(W) @ rowsum(H)
        # structure (cheaper, and the same float summation shape as
        # beta_divergence)
        wh_total = jnp.einsum(
            "bk,bk->b", jnp.sum(w, axis=-2), jnp.sum(h, axis=-1),
            precision=jax.lax.Precision.HIGHEST,
        )
        local = (
            jnp.sum(jnp.where(mask, x * jnp.log(div), 0.0), axis=(-1, -2))
            + wh_total
            - jnp.sum(jnp.where(mask, x, 0.0), axis=(-1, -2))
        )
    elif beta == 0.0:
        local = (
            jnp.sum(jnp.where(mask, div, 0.0), axis=(-1, -2))
            - x.shape[-1] * x.shape[-2]  # local share of np.prod(X.shape)
            - jnp.sum(jnp.where(mask, jnp.log(div), 0.0), axis=(-1, -2))
        )
    else:
        sum_wh_beta = jnp.sum(wh**beta, axis=(-1, -2))
        sum_x_wh = jnp.sum(
            jnp.where(mask, x * whc ** (beta - 1.0), 0.0), axis=(-1, -2)
        )
        local = (
            jnp.sum(jnp.where(mask, x**beta, 0.0), axis=(-1, -2))
            - beta * sum_x_wh
            + sum_wh_beta * (beta - 1.0)
        ) / (beta * (beta - 1.0))
    res = time_sum(local, axis_name)
    return jnp.sqrt(2.0 * jnp.maximum(res, 0.0))


def sharded_fit_beta(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    mesh: Mesh,
    beta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> "BetaState":
    """Beta-divergence MU-NMF to convergence on a ``(data, time)`` mesh.

    The sequence-parallel execution of
    :func:`muscle_synergies_tpu.models.beta.fit_mu_beta` for any float
    ``beta`` (1.0 = KL, 0.0 = Itakura-Saito, arbitrary floats as
    sklearn accepts and the reference forwards): exact, with the H
    update's two projections the only collectives.  Stopping semantics
    are sklearn's, per trial, with converged trials frozen; the L1/L2
    denominator penalties (pre-scaled from the GLOBAL shape, as
    ``models.select`` computes them) are local additions exactly as in
    :func:`muscle_synergies_tpu.models.beta.mu_update_beta`.
    """
    from ..models.beta import BetaState

    beta = float(beta)
    local_step = functools.partial(
        _local_beta_step, beta=beta,
        l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
        l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
    )
    local_error = functools.partial(_local_beta_error, beta=beta)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None),
        ),
        out_specs=BetaState(
            w=P(DATA_AXIS, TIME_AXIS, None),
            h=P(DATA_AXIS, None, None),
            n_iter=P(DATA_AXIS),
            previous_error=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, wb, hb):
        return _convergence_driver(
            xb, wb, hb, local_step, local_error, TIME_AXIS,
            BetaState, max_iter, tol, check_every,
        )

    return fit(x, w0, h0)


def sharded_fit_kl(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
) -> "BetaState":
    """KL specialization of :func:`sharded_fit_beta` (``beta=1``)."""
    return sharded_fit_beta(
        x, w0, h0, mesh, beta=1.0, max_iter=max_iter, tol=tol,
        check_every=check_every,
        l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
        l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
    )


@full_precision
def _local_mu_step_tp(
    x, w, h, axis_name: str,
    l1_reg_w: float = 0.0, l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0, l2_reg_h: float = 0.0,
    inner_iter: int = 1,
):
    """One MU iteration with the *channel* axis sharded (tensor parallel).

    Shapes (local): x ``(b, n, l_loc)``, w ``(b, n, k)`` replicated
    over the model group, h ``(b, k, l_loc)``.  The W update contracts
    over channels, so its cross products ``X Ht`` and ``H Ht`` are
    ``psum``'d over the model axis; the H update is then fully local
    (each shard updates its own channel slice of H from the replicated
    W).  This is the layout for very wide channel counts (HD-sEMG
    grids), per SURVEY §2.5's tensor-parallelism row.  The pre-scaled
    L1/L2 penalties and the accelerated-MU ``inner_iter`` enter
    exactly as in the local solver — penalties are scalar denominator
    additions, so sharding H's channel axis does not change them.
    """
    ht = jnp.swapaxes(h, -1, -2)
    # --- W updates: channel-reduced cross products, fixed while H is ---
    xht = axis_sum(x @ ht, axis_name)
    hht = axis_sum(h @ ht, axis_name)
    for _ in range(inner_iter):
        denominator = w @ hht
        if l1_reg_w > 0:
            denominator = denominator + l1_reg_w
        if l2_reg_w > 0:
            denominator = denominator + l2_reg_w * w
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        w = w * (xht / denominator)

    # --- H updates: fully local per channel shard ---
    wt = jnp.swapaxes(w, -1, -2)
    wtx = wt @ x
    wtw = wt @ w
    for _ in range(inner_iter):
        denominator = wtw @ h
        if l1_reg_h > 0:
            denominator = denominator + l1_reg_h
        if l2_reg_h > 0:
            denominator = denominator + l2_reg_h * h
        denominator = jnp.where(denominator == 0, EPSILON, denominator)
        h = h * (wtx / denominator)
    return w, h


def _local_error_tp(x, w, h, axis_name: str):
    """Per-trial Frobenius error with channel sums ``psum``'d.

    ``Precision.HIGHEST`` reconstruction (stopping-statistic
    discipline, see :func:`_local_error`).
    """
    diff = x - jnp.matmul(w, h, precision=jax.lax.Precision.HIGHEST)
    sq = axis_sum(jnp.sum(diff * diff, axis=(-1, -2)), axis_name)
    return jnp.sqrt(sq)


def sharded_fit_mu_tp(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
    inner_iter: int = 1,
) -> MUState:
    """Run MU-NMF on a ``(data, model)`` mesh: trials x channel shards.

    The tensor-parallel counterpart of :func:`sharded_fit_mu`: ``H``
    (and ``X``'s channel axis) shard over ``"model"``, ``W`` is
    replicated within a model group, and the W update's Grams cross
    shards as two tiny ``psum``s per iteration.  Semantics match
    :func:`muscle_synergies_tpu.models.mu.fit_mu` exactly.

    Args:
        x: ``(B, N, L)`` batch, sharded ``P(data, None, model)``.
        w0: ``(B, N, k)``, sharded ``P(data, None, None)``.
        h0: ``(B, k, L)``, sharded ``P(data, None, model)``.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, MODEL_AXIS),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS, None, MODEL_AXIS),
        ),
        out_specs=MUState(
            w=P(DATA_AXIS, None, None),
            h=P(DATA_AXIS, None, MODEL_AXIS),
            n_iter=P(DATA_AXIS),
            previous_error=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, wb, hb):
        local_step = functools.partial(
            _local_mu_step_tp,
            l1_reg_w=l1_reg_w, l2_reg_w=l2_reg_w,
            l1_reg_h=l1_reg_h, l2_reg_h=l2_reg_h,
            inner_iter=inner_iter,
        )
        return _convergence_driver(
            xb, wb, hb, local_step, _local_error_tp, MODEL_AXIS,
            MUState, max_iter, tol, check_every,
        )

    return fit(x, w0, h0)


@full_precision
def _local_cd_pass_w(
    x, w, h, axis_name: str, l1_reg: float = 0.0, l2_reg: float = 0.0
):
    """One cyclic CD pass over W's components (H fixed), time-sharded.

    The Gram ``H Ht`` and the rows of ``X Ht`` are local to each time
    shard (W rows live with their samples), so only the violation
    statistic crosses shards.  Shapes: x ``(b, n_loc, L)``,
    w ``(b, n_loc, k)``, h ``(b, k, L)`` (replicated in the time group).
    L1 subtracts from ``X Ht`` and L2 adds to the Gram diagonal,
    exactly as in :func:`muscle_synergies_tpu.models.hals.cd_pass` —
    both are local operations.
    """
    k = w.shape[-1]
    ht = jnp.swapaxes(h, -1, -2)
    hht = h @ ht  # (b, k, k), replicated over time
    xht = x @ ht  # (b, n_loc, k), local rows
    if l2_reg != 0.0:
        hht = hht + l2_reg * jnp.eye(k, dtype=hht.dtype)
    if l1_reg != 0.0:
        xht = xht - l1_reg
    violation = jnp.zeros(w.shape[0], x.dtype)
    for s in range(k):
        grad = jnp.einsum("bnk,bk->bn", w, hht[:, :, s]) - xht[:, :, s]
        pg = jnp.where(w[:, :, s] == 0.0, jnp.minimum(grad, 0.0), grad)
        violation = violation + jnp.sum(jnp.abs(pg), axis=1)
        hess = hht[:, s, s][:, None]
        new_col = jnp.maximum(
            w[:, :, s] - grad / jnp.where(hess == 0, 1.0, hess), 0.0
        )
        w = w.at[:, :, s].set(jnp.where(hess != 0, new_col, w[:, :, s]))
    return w, time_sum(violation, axis_name)


@full_precision
def _local_cd_pass_h(
    x, w, h, axis_name: str, l1_reg: float = 0.0, l2_reg: float = 0.0
):
    """One cyclic CD pass over H's components (W fixed), time-sharded.

    H's update is the W-pass on ``X.T`` (sklearn's symmetry): the Grams
    ``Wt W`` and cross products ``Wt X`` reduce over the sharded time
    axis, so each needs one ``psum``; the per-component updates are
    then identical on every shard of a time group.  The penalties
    apply AFTER the psums (to the completed global Gram/cross
    products), matching the local solver exactly.
    """
    k = w.shape[-1]
    wt = jnp.swapaxes(w, -1, -2)
    wtw = time_sum(wt @ w, axis_name)  # (b, k, k)
    wtx = time_sum(wt @ x, axis_name)  # (b, k, L)
    if l2_reg != 0.0:
        wtw = wtw + l2_reg * jnp.eye(k, dtype=wtw.dtype)
    if l1_reg != 0.0:
        wtx = wtx - l1_reg
    violation = jnp.zeros(h.shape[0], x.dtype)
    for s in range(k):
        grad = jnp.einsum("bk,bkl->bl", wtw[:, s, :], h) - wtx[:, s, :]
        pg = jnp.where(h[:, s, :] == 0.0, jnp.minimum(grad, 0.0), grad)
        violation = violation + jnp.sum(jnp.abs(pg), axis=1)
        hess = wtw[:, s, s][:, None]
        new_row = jnp.maximum(
            h[:, s, :] - grad / jnp.where(hess == 0, 1.0, hess), 0.0
        )
        h = h.at[:, s, :].set(jnp.where(hess != 0, new_row, h[:, s, :]))
    # the violation from the H pass is already identical on every time
    # shard (inputs to it were psum'd), so no further reduction
    return h, violation


def sharded_fit_cd(
    x: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    l1_reg_w: float = 0.0,
    l2_reg_w: float = 0.0,
    l1_reg_h: float = 0.0,
    l2_reg_h: float = 0.0,
):
    """Run coordinate-descent NMF to convergence on a ``(data, time)`` mesh.

    Semantics match :func:`muscle_synergies_tpu.models.hals.fit_cd`
    (sklearn's 'cd' solver with ``shuffle=False``): per outer iteration
    one cyclic pass over W then H, stopping when the summed |projected
    gradient| falls below ``tol`` relative to the first iteration's;
    the same L1/L2 penalties (pass values pre-scaled from the GLOBAL
    shape), with L2 on the Gram diagonal and L1 on the cross products.

    Args:
        x: ``(B, N, L)`` batch, sharded ``P(data, time, None)``.
        w0: ``(B, N, k)``, sharded like ``x``.
        h0: ``(B, k, L)``, sharded ``P(data, None, None)``.

    Returns:
        a :class:`~muscle_synergies_tpu.models.hals.CDState`-shaped
        tuple ``(w, ht, n_iter, violation_init, converged)`` with
        batched leading axes (``ht`` is ``(B, L, k)``).
    """
    from ..models.hals import CDState

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None),
        ),
        out_specs=CDState(
            w=P(DATA_AXIS, TIME_AXIS, None),
            ht=P(DATA_AXIS, None, None),
            n_iter=P(DATA_AXIS),
            violation_init=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, wb, hb):
        b = xb.shape[0]

        def body(state: CDState) -> CDState:
            h = jnp.swapaxes(state.ht, -1, -2)
            w_new, violation_w = _local_cd_pass_w(
                xb, state.w, h, TIME_AXIS, l1_reg_w, l2_reg_w
            )
            h_new, violation_h = _local_cd_pass_h(
                xb, w_new, h, TIME_AXIS, l1_reg_h, l2_reg_h
            )
            violation = violation_w + violation_h
            keep = state.converged
            w = jnp.where(keep[:, None, None], state.w, w_new)
            ht = jnp.where(
                keep[:, None, None], state.ht, jnp.swapaxes(h_new, -1, -2)
            )
            n_iter = jnp.where(keep, state.n_iter, state.n_iter + 1)
            violation_init = jnp.where(
                jnp.logical_and(n_iter == 1, ~keep),
                violation,
                state.violation_init,
            )
            newly = jnp.logical_or(
                violation_init == 0, violation / violation_init <= tol
            )
            converged = jnp.logical_or(keep, newly)
            return CDState(w, ht, n_iter, violation_init, converged)

        def cond(state: CDState) -> jnp.ndarray:
            return jnp.logical_and(
                jnp.max(state.n_iter) < max_iter,
                ~jnp.all(state.converged),
            )

        init = CDState(
            w=wb,
            ht=jnp.swapaxes(hb, -1, -2),
            n_iter=mark_varying(jnp.zeros((b,), jnp.int32), DATA_AXIS),
            violation_init=mark_varying(jnp.zeros((b,), xb.dtype), DATA_AXIS),
            converged=mark_varying(jnp.zeros((b,), bool), DATA_AXIS),
        )
        return jax.lax.while_loop(cond, body, init)

    return fit(x, w0, h0)
