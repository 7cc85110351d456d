"""Mesh-sharded space-by-time (NM3F) factorization: data x time.

Extends the mesh-sharded solver family to
:mod:`muscle_synergies_tpu.models.nm3f`.  The model couples trials
through the SHARED temporal/spatial modules, so the sharding story
differs from the per-trial solvers:

- trials (and their coefficient matrices ``A_b``) shard over ``data``;
  the A update is embarrassingly parallel across trials;
- the shared TIME BASE shards over ``time`` (sequence parallelism for
  long shared time axes): ``W`` is ``P(time, None)`` and every sum
  over samples — ``WᵀW``, the A numerators ``Wᵀ X_b Sᵀ``, the S
  numerator ``Σ_b A_bᵀ Wᵀ X_b`` — closes with a psum over ``time``,
  while the W update's output axis IS the time axis, so it needs no
  collective at all;
- ``S`` stays replicated; its update reduces over trials and samples,
  and the local contributions close with one psum pair — numerator
  and Gram are tiny ``(Q, L)/(Q, Q)`` matrices, so the collective
  volume is independent of both the trial count and the sequence
  length (the classic gradient-allreduce shape);
- the stopping criterion is GLOBAL (one total-Frobenius error across
  all trials, one converged flag), matching
  :func:`~muscle_synergies_tpu.models.nm3f.fit_nm3f` exactly: the
  local squared errors psum over both axes before the sqrt.

A pure-DP mesh (``make_mesh((n, 1))``) degrades to the data-parallel
scheme (every time psum spans one shard); parity with the local fit
holds up to psum float reordering, tested on the 8-device CPU mesh in
``(8, 1)``, ``(2, 4)`` and ``(1, 8)`` layouts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.mu import EPSILON, full_precision
from ..models.nm3f import NM3FState
from .collectives import axis_sum
from .nmf import DATA_AXIS
from .mesh import TIME_AXIS

__all__ = ["sharded_fit_nm3f"]


@full_precision
def _local_nm3f_step(
    xb, w, ab, s, data_axis: str, time_axis: str, precision=None
):
    """One A-then-W-then-S update on this shard's trials and samples.

    Mirrors :func:`muscle_synergies_tpu.models.nm3f.nm3f_update` with
    the trial reductions psum'd over ``data`` and the sample
    reductions psum'd over ``time``; shapes xb ``(b_loc, t_loc, L)``,
    w ``(t_loc, P)`` time-sharded, s ``(Q, L)`` replicated,
    ab ``(b_loc, P, Q)`` data-sharded.
    """
    mm = functools.partial(jnp.matmul, precision=precision)
    wtw = axis_sum(mm(w.T, w), time_axis)  # (P, P) global Gram
    sst = mm(s, s.T)
    num_a = axis_sum(
        jnp.einsum("tp,btl,ql->bpq", w, xb, s, precision=precision),
        time_axis,
    )
    den_a = jnp.einsum("pr,brm,mq->bpq", wtw, ab, sst, precision=precision)
    ab = ab * (num_a / jnp.where(den_a == 0, EPSILON, den_a))

    # W's output axis is the time axis: numerator rows stay local
    num_w = axis_sum(
        jnp.einsum("btl,ql,bpq->tp", xb, s, ab, precision=precision),
        data_axis,
    )
    gram_w = axis_sum(
        jnp.einsum("bpq,qm,brm->pr", ab, sst, ab, precision=precision),
        data_axis,
    )
    den_w = mm(w, gram_w)
    w = w * (num_w / jnp.where(den_w == 0, EPSILON, den_w))

    wtw = axis_sum(mm(w.T, w), time_axis)  # refresh with the new W
    num_s = axis_sum(
        axis_sum(
            jnp.einsum("bpq,tp,btl->ql", ab, w, xb, precision=precision),
            data_axis,
        ),
        time_axis,
    )
    gram_s = axis_sum(
        jnp.einsum("bpq,pr,brm->qm", ab, wtw, ab, precision=precision),
        data_axis,
    )
    den_s = mm(gram_s, s)
    s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))
    return w, ab, s


def _local_nm3f_error(
    xb, w, ab, s, data_axis: str, time_axis: str, precision=None
):
    """Total Frobenius error, trial and sample sums psum'd."""
    rec = jnp.einsum("tp,bpq,ql->btl", w, ab, s, precision=precision)
    diff = xb - rec
    local = jnp.sum(diff * diff)
    return jnp.sqrt(axis_sum(axis_sum(local, data_axis), time_axis))


def sharded_fit_nm3f(
    xs: jnp.ndarray,
    w0: jnp.ndarray,
    a0: jnp.ndarray,
    s0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 500,
    tol: float = 1e-5,
    check_every: int = 10,
    precision=None,
) -> NM3FState:
    """Run the space-by-time factorization on a ``(data, time)`` mesh.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``P(data, time, None)``.
        w0: ``(T, P)`` temporal modules, sharded ``P(time, None)``.
        a0: ``(B, P, Q)`` coefficients, sharded ``P(data)``.
        s0: ``(Q, L)`` spatial modules, replicated.

    Returns:
        :class:`~muscle_synergies_tpu.models.nm3f.NM3FState` with the
        same shardings; semantics match
        :func:`~muscle_synergies_tpu.models.nm3f.fit_nm3f` (global
        stopping — the modules couple every trial).  ``precision``
        threads through the update contractions, matching the local
        solver's knob (see models/nm3f.py module docstring); the
        stopping criterion's error checks default to
        ``Precision.HIGHEST`` regardless, like
        :func:`~muscle_synergies_tpu.models.nm3f.fit_nm3f`.
    """
    check_precision = (
        precision if precision is not None else jax.lax.Precision.HIGHEST
    )
    n_data = mesh.shape[DATA_AXIS]
    n_time = mesh.shape[TIME_AXIS]
    if xs.shape[0] % n_data:
        raise ValueError(
            f"trial count {xs.shape[0]} must divide over {n_data} "
            "data shards"
        )
    if xs.shape[1] % n_time:
        raise ValueError(
            f"sample count {xs.shape[1]} must divide over {n_time} "
            "time shards"
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(TIME_AXIS, None),
            P(DATA_AXIS, None, None),
            P(None, None),
        ),
        out_specs=NM3FState(
            w=P(TIME_AXIS, None),
            a=P(DATA_AXIS, None, None),
            s=P(None, None),
            n_iter=P(),
            previous_error=P(),
            converged=P(),
        ),
    )
    def fit(xb, w, ab, s):
        error_init = _local_nm3f_error(
            xb, w, ab, s, DATA_AXIS, TIME_AXIS, precision=check_precision
        )

        def cond(state: NM3FState):
            return (state.n_iter < max_iter) & ~state.converged

        def body(state: NM3FState):
            # hard max_iter cap, matching fit_nm3f's tail chunk
            steps = jnp.minimum(check_every, max_iter - state.n_iter)

            def one(_, was):
                return _local_nm3f_step(
                    xb, *was, data_axis=DATA_AXIS, time_axis=TIME_AXIS,
                    precision=precision,
                )

            w_, a_, s_ = jax.lax.fori_loop(
                0, steps, one, (state.w, state.a, state.s)
            )
            n_iter = state.n_iter + steps
            error = _local_nm3f_error(
                xb, w_, a_, s_, DATA_AXIS, TIME_AXIS,
                precision=check_precision,
            )
            improvement = (state.previous_error - error) / jnp.maximum(
                error_init, EPSILON
            )
            converged = jnp.logical_and(
                improvement < tol, n_iter % check_every == 0
            )
            return NM3FState(w_, a_, s_, n_iter, error, converged)

        init = NM3FState(
            w,
            ab,
            s,
            jnp.asarray(0, jnp.int32),
            error_init,
            jnp.asarray(False),
        )
        return jax.lax.while_loop(cond, body, init)

    return fit(xs, w0, a0, s0)
