#!/usr/bin/env python
"""Solver benchmark on a 1024-trial batch, and a device numerics check.

Default mode measures the throughput of the batched solver iteration
(rank-4 synergies from 8-channel gait EMG, 200 time-normalized samples
per trial — the BASELINE.json configuration) on the default JAX
device: iterations per second of ``--iters`` updates, timed warm as the
median of ``--repeats`` runs ended by ``block_until_ready``.

``--solver {mu,cd,kl,is,cnmf,nm3f}`` selects the iteration: Frobenius
multiplicative updates (the headline), HALS coordinate descent
(sklearn's default ``solver='cd'``), KL-loss and Itakura-Saito MU, the
convolutive (time-varying) updates and the space-by-time (NM3F)
updates.  ``--impl`` goes through
:func:`muscle_synergies_tpu.utils.platform.resolve_impl`.

``--metric vaf`` measures time to 90% batch VAF on the calibrated gait
regime (32 distinct seeded captures through the tutorial pipeline,
tiled to the batch): the on-device iteration count priced at the
measured per-iteration time, with ``vs_baseline`` the speedup over the
float64 numpy reference solving the same trials one at a time on the
host (the reference package's execution model).  ``--metric fit`` times
the whole convergence fit for the resolved implementation and for XLA.

``--check`` validates device numerics instead of speed: every solver
path that ``impl="auto"`` picks on the active platform (the Triton
kernels on a GPU, XLA elsewhere) and the zero-phase filter are compared
with the float64 host references of :mod:`muscle_synergies_tpu.reference`
against the documented tolerances.

The benchmark measures a GPU: without one it exits non-zero, unless
``JAX_PLATFORMS=cpu`` was given explicitly (CPU runs check the
plumbing, not speed).  Every mode prints one JSON line:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "device": {"platform": ..., "kind": ..., "count": ...}}
"""

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np

_FAMILY = {
    "mu": "mu", "cd": "cd", "kl": "beta", "is": "beta", "cnmf": "cnmf",
    "nm3f": "nm3f",
}


def _parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--samples", type=int, default=200)
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--rank", type=int, default=4)
    parser.add_argument("--iters", type=int, default=1000,
                        help="solver iterations per timed run")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--quick", action="store_true",
                        help="tiny smoke-test configuration")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument(
        "--impl", choices=["auto", "pallas", "xla"], default="auto",
        help="auto = the Triton kernel on a GPU where the family has "
             "one, XLA elsewhere",
    )
    parser.add_argument(
        "--solver", choices=["mu", "cd", "kl", "is", "cnmf", "nm3f"],
        default="mu",
        help="which solver iteration to measure/check: mu = Frobenius "
             "multiplicative updates (headline), cd = HALS coordinate "
             "descent (sklearn's default solver), kl / is = "
             "beta-divergence MU (beta=1 / beta=0), cnmf = the "
             "convolutive (time-varying synergy) updates, nm3f = the "
             "space-by-time trilinear updates (--rank temporal modules "
             "x --spatial spatial modules, shared across the batch)",
    )
    parser.add_argument(
        "--metric", choices=["iters", "vaf", "fit"], default="iters",
        help="iters = solver iterations/sec (headline); vaf = "
             "time-to-90%%-VAF; fit = full convergence-fit wall time "
             "for the batch, resolved impl vs XLA",
    )
    parser.add_argument("--vaf-target", type=float, default=0.90)
    parser.add_argument("--lags", type=int, default=10,
                        help="temporal extent of each synergy "
                             "(--solver cnmf only)")
    parser.add_argument("--spatial", type=int, default=3,
                        help="spatial module count Q of the space-by-"
                             "time model (--solver nm3f only; --rank "
                             "is the temporal module count P)")
    parser.add_argument(
        "--check", action="store_true",
        help="validate the solver paths that run on the active device "
             "against float64 host references instead of timing",
    )
    return parser.parse_args(argv)


def _utc_date() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def _require_device():
    """Fail without a GPU, unless the CPU was asked for explicitly."""
    import jax

    if jax.default_backend() == "gpu":
        return
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return
    raise SystemExit(
        f"bench.py measures a GPU; the default JAX backend is "
        f"{jax.default_backend()!r}. Set JAX_PLATFORMS=cpu to run the "
        "CPU plumbing checks."
    )


def _emit(record) -> None:
    """Print one JSON result line naming the device it ran on."""
    import jax

    dev = jax.devices()[0]
    record["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    print(json.dumps(record))


def _impl(args):
    from muscle_synergies_tpu.utils.platform import resolve_impl

    return resolve_impl(args.impl, _FAMILY[args.solver])


def _median_seconds(fn, repeats):
    """Warm ``fn`` (compiles), then the median of ``repeats`` timed runs,
    each ended by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _nm3f_avg(x_np, n_temporal, n_spatial):
    """Init magnitude: trilinear ``E[X̂] ≈ P·Q·c³ = mean(X)``."""
    return float(
        (x_np.mean() / (n_temporal * n_spatial)) ** (1.0 / 3.0)
    )


def _make_problem(args, dtype, solver="mu"):
    """Synthetic gait-like envelopes: nonneg low-rank + noise.

    The Itakura-Saito objective has poles at zero, so its problem is
    shifted strictly positive (sklearn raises on zeros for beta <= 0).
    """
    rng = np.random.default_rng(0)
    w_true = rng.random((args.batch, args.samples, 3))
    h_true = rng.random((args.batch, 3, args.channels))
    x_np = (w_true @ h_true + 0.05 * rng.random(
        (args.batch, args.samples, args.channels))).astype(dtype)
    if solver == "is":
        x_np = x_np + np.asarray(0.05, dtype)
    return x_np


def _make_gait_problem(args, dtype, solver="mu", n_distinct=32):
    """The calibrated gait regime for the time-to-VAF metric.

    Each distinct trial is a different seeded
    ``testing.gait_emg_array`` capture run through the tutorial
    pipeline (zero-center -> 0.5 s RMS -> time-normalize ->
    amplitude-normalize), the regime the repo's VAF anchor pins to the
    reference notebook's 0.9567-at-rank-2 (tests/test_vaf_anchor.py).
    Convergence to 90% VAF here takes a realistic iteration count,
    unlike the synthetic low-rank batch, which solves in ~10
    iterations.
    Tiling the distinct problems to ``args.batch`` fills the batch
    without changing per-trial convergence behavior.
    """
    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.testing import gait_emg_array
    from muscle_synergies_tpu.utils.config import PipelineConfig

    n_distinct = min(n_distinct, args.batch)
    trials = [gait_emg_array(seed=100 + i) for i in range(n_distinct)]
    cfg = PipelineConfig(
        use_rms=True,
        rms_window_s=0.5,
        reduce_to=args.samples,
        amplitude_normalize=True,
        zero_center=True,
    )
    batch = np.asarray(preprocess_trials(trials, 2000.0, cfg, dtype=dtype))
    if solver == "is":
        batch = batch + np.asarray(0.05, dtype)
    reps = -(-args.batch // n_distinct)
    return np.tile(batch, (reps, 1, 1))[: args.batch]


def _fresh_factors(args, dtype, seed, avg):
    import jax.numpy as jnp

    r = np.random.default_rng(seed)
    if getattr(args, "solver", "mu") == "nm3f":
        wt = jnp.asarray(avg * np.abs(r.standard_normal(
            (args.samples, args.rank))).astype(dtype))
        a0 = jnp.asarray(avg * np.abs(r.standard_normal(
            (args.batch, args.rank, args.spatial))).astype(dtype))
        s0 = jnp.asarray(avg * np.abs(r.standard_normal(
            (args.spatial, args.channels))).astype(dtype))
        return wt, (a0, s0)  # shared W, (per-trial A, shared S)
    w0 = jnp.asarray(avg * np.abs(r.standard_normal(
        (args.batch, args.samples, args.rank))).astype(dtype))
    if getattr(args, "solver", "mu") == "cnmf":
        s0 = jnp.asarray(avg * np.abs(r.standard_normal(
            (args.batch, args.rank, args.lags, args.channels)
        )).astype(dtype))
        return w0, s0  # activations C, synergies S
    h0 = jnp.asarray(avg * np.abs(r.standard_normal(
        (args.batch, args.rank, args.channels))).astype(dtype))
    return w0, h0


def _make_step(impl, solver="mu"):
    """Return ``step(xs, w, h, iters)`` for the chosen solver/impl."""
    from muscle_synergies_tpu.models.batch import (
        beta_mu_iterations_batch,
        cd_iterations_batch,
        mu_iterations_batch,
    )

    if solver == "nm3f":
        import jax

        from muscle_synergies_tpu.models.nm3f import nm3f_update

        # factor slots: w = shared temporal modules W (T, P); the
        # second slot carries the (A, S) pair as a pytree — per-trial
        # coefficients (B, P, Q) and shared spatial modules (Q, L)
        def step_fn(xs, w, a_s, iters):
            def one(_, was):
                return nm3f_update(xs, *was)

            w, a, s = jax.lax.fori_loop(0, iters, one, (w, *a_s))
            return w, (a, s)
    elif solver == "cnmf":
        from muscle_synergies_tpu.models.cnmf import cnmf_iterations_batch

        def step_fn(xs, c, srg, iters):
            return cnmf_iterations_batch(xs, c, srg, iters)
    elif solver == "mu":
        def step_fn(xs, w, h, iters):
            return mu_iterations_batch(xs, w, h, iters, impl=impl)
    elif solver == "cd":
        def step_fn(xs, w, h, iters):
            return cd_iterations_batch(xs, w, h, iters, impl=impl)
    else:
        beta = 1.0 if solver == "kl" else 0.0

        def step_fn(xs, w, h, iters):
            return beta_mu_iterations_batch(
                xs, w, h, iters, beta=beta, impl=impl
            )
    return step_fn


def _avg(args, x_np):
    """Init magnitude for the fresh factors of each solver family."""
    if args.solver == "nm3f":
        return _nm3f_avg(x_np, args.rank, args.spatial)
    denom = args.rank * (args.lags if args.solver == "cnmf" else 1)
    return float(np.sqrt(x_np.mean() / denom))


def _seconds_per_call(step_fn, xs, args, dtype, avg):
    """Median seconds of one jitted ``step_fn`` call of ``args.iters``."""
    import jax

    w, h = _fresh_factors(args, dtype, 0, avg)
    run = jax.jit(lambda xs, w, h: step_fn(xs, w, h, args.iters))
    return _median_seconds(lambda: run(xs, w, h), args.repeats)


def run_iters(args):
    """Headline metric: solver iterations per second."""
    import jax.numpy as jnp

    impl = _impl(args)
    step_fn = _make_step(impl, args.solver)
    dtype = jnp.dtype(args.dtype)
    x_np = _make_problem(args, dtype, args.solver)
    per_call = _seconds_per_call(
        step_fn, jnp.asarray(x_np), args, dtype, _avg(args, x_np)
    )
    iters_per_sec = args.iters / per_call
    note = {"cnmf": f", lags={args.lags}", "nm3f": f", Q={args.spatial}"}
    # one convolutive iteration does ~lags x the work of a plain one, so
    # cnmf's baseline ratio counts lag-slice updates
    effective = iters_per_sec * (args.lags if args.solver == "cnmf" else 1)
    record = {
        "metric": f"{args.solver}_nmf_iterations_per_sec_per_chip",
        "value": round(iters_per_sec, 2),
        "unit": f"iter/s (batch={args.batch}x{args.samples}x"
                f"{args.channels}, k={args.rank}"
                f"{note.get(args.solver, '')}, {dtype.name}, {impl})",
        "vs_baseline": round(effective / 10_000.0, 4),
    }
    if args.solver != "mu":
        # the headline MU line keeps its fixed key set; the per-solver
        # lines carry a date stamp
        record["date"] = _utc_date()
    _emit(record)
    return 0


def _reference_time_per_trial(x_np, rank, n_iter, solver):
    """Median host time of the float64 numpy reference on one trial."""
    from muscle_synergies_tpu import reference as ref

    step = {
        "mu": ref.mu_iterations, "cd": ref.cd_iterations,
        "kl": ref.kl_iterations, "is": ref.is_iterations,
    }[solver]
    rng = np.random.default_rng(0)
    times = []
    for b in range(min(4, x_np.shape[0])):
        x = np.asarray(x_np[b], dtype=np.float64)
        w = rng.random((x.shape[0], rank))
        h = rng.random((rank, x.shape[1]))
        t0 = time.perf_counter()
        step(x, w, h, n_iter)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_vaf(args):
    """Time to >= ``vaf_target`` VAF across the calibrated gait batch.

    The convergence loop runs entirely on device (one dispatch); its
    iteration count is priced at the measured per-iteration time.
    ``vs_baseline`` compares against the float64 reference solving the
    same problems one trial at a time on the host.
    """
    import jax
    import jax.numpy as jnp

    from muscle_synergies_tpu.models.batch import init_batch, vaf_batch

    impl = _impl(args)
    step_fn = _make_step(impl, args.solver)
    dtype = jnp.dtype(args.dtype)
    x_np = _make_gait_problem(args, dtype, args.solver)
    xs = jnp.asarray(x_np)
    w0, h0 = init_batch(xs, args.rank, init="nndsvda", seed=1)
    w0, h0 = w0.astype(dtype), h0.astype(dtype)
    max_iter = 500
    target = args.vaf_target

    @jax.jit
    def run_to_vaf(xs, w, h):
        def cond(c):
            _, _, n, done = c
            return jnp.logical_and(~done, n < max_iter)

        def body(c):
            w, h, n, _ = c
            w, h = step_fn(xs, w, h, 1)
            overall, _ = vaf_batch(xs, w, h)
            return w, h, n + 1, jnp.all(overall >= target)

        _, _, n, done = jax.lax.while_loop(
            cond, body, (w, h, jnp.int32(0), jnp.array(False))
        )
        return n, done

    n_iter, done = run_to_vaf(xs, w0, h0)
    n_iter = int(n_iter)
    if not bool(done):
        _emit({
            "metric": f"time_to_{int(target * 100)}pct_vaf",
            "value": -1,
            "unit": f"not reached in {n_iter} iters",
            "vs_baseline": 0,
        })
        return 1
    per_call = _seconds_per_call(step_fn, xs, args, dtype, _avg(args, x_np))
    seconds = n_iter * per_call / args.iters
    ref_total = _reference_time_per_trial(
        x_np, args.rank, n_iter, args.solver
    ) * args.batch
    _emit({
        "metric": f"time_to_{int(target * 100)}pct_vaf",
        "value": round(seconds * 1e3, 3),
        "unit": f"ms for {args.batch} calibrated-gait trials "
                f"({n_iter} {args.solver} iters, rank={args.rank}, "
                f"{impl}; float64 host reference trial-by-trial: "
                f"{ref_total:.1f} s)",
        "vs_baseline": round(ref_total / seconds, 1),
        "date": _utc_date(),
    })
    return 0


def _make_fit(impl, args, max_iter, tol):
    from muscle_synergies_tpu.models.batch import (
        fit_cd_batch,
        fit_mu_batch,
        fit_mu_beta_batch,
    )

    if args.solver == "mu":
        return lambda xs, w, h: fit_mu_batch(
            xs, w, h, max_iter=max_iter, tol=tol, impl=impl
        )
    if args.solver == "cd":
        return lambda xs, w, h: fit_cd_batch(
            xs, w, h, max_iter=max_iter, tol=tol, impl=impl
        )
    if args.solver == "nm3f":
        from muscle_synergies_tpu.models.nm3f import fit_nm3f

        return lambda xs, w, a_s: fit_nm3f(
            xs, w, *a_s, max_iter=max_iter, tol=tol
        )
    if args.solver == "cnmf":
        from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch

        return lambda xs, c, s: fit_cnmf_batch(
            xs, c, s, max_iter=max_iter, tol=tol
        )
    beta = 1.0 if args.solver == "kl" else 0.0
    return lambda xs, w, h: fit_mu_beta_batch(
        xs, w, h, beta=beta, max_iter=max_iter, tol=tol, impl=impl
    )


def run_fit(args):
    """Convergence-fit wall time: the whole batch solved to tolerance,
    for the resolved ``--impl`` and for XLA; ``vs_baseline`` is the
    XLA/resolved time ratio (1.0 when the resolved impl is XLA)."""
    import jax.numpy as jnp

    dtype = jnp.dtype(args.dtype)
    x_np = _make_problem(args, dtype, args.solver)
    xs = jnp.asarray(x_np)
    w, h = _fresh_factors(args, dtype, 0, _avg(args, x_np))
    max_iter, tol = 500, 1e-4

    def time_impl(impl):
        fit = _make_fit(impl, args, max_iter, tol)
        return _median_seconds(lambda: fit(xs, w, h), args.repeats)

    impl = _impl(args)
    xla_s = time_impl("xla")
    main_s = time_impl(impl) if impl != "xla" else xla_s
    _emit({
        "metric": f"{args.solver}_fit_ms_batch",
        "value": round(main_s * 1e3, 3),
        "unit": f"ms per full {args.batch}-trial fit to tol={tol:g} "
                f"(max_iter={max_iter}, {impl}; xla={xla_s * 1e3:.1f} ms)",
        "vs_baseline": round(xla_s / main_s, 2),
        "date": _utc_date(),
    })
    return 0


def _max_factor_error(dev_w, dev_h, ref_fn, b):
    """Worst ``factor_error`` over the first ``b`` trials."""
    from muscle_synergies_tpu.reference import factor_error

    dev_w, dev_h = np.asarray(dev_w), np.asarray(dev_h)
    return max(
        factor_error(dev_w[i], dev_h[i], *ref_fn(i)) for i in range(b)
    )


def _fit_error(dev_w, dev_h, dev_n, ref_fit, b):
    """Worst iterate error and stopping drift of a device fit against
    a float64 host fit, compared at the device's own stopping
    iteration (see :mod:`muscle_synergies_tpu.reference`)."""
    from muscle_synergies_tpu.reference import factor_error

    dev_w, dev_h = np.asarray(dev_w), np.asarray(dev_h)
    dev_n = np.asarray(dev_n, dtype=np.int64)
    err, gap = 0.0, 0
    for i in range(b):
        snaps, n_ref = ref_fit(i)
        w_ref, h_ref = snaps[int(dev_n[i])][:2]
        err = max(err, factor_error(dev_w[i], dev_h[i], w_ref, h_ref))
        gap = max(gap, abs(int(dev_n[i]) - n_ref))
    return err, gap


# Documented float32 tolerances against the float64 host references.
# Fixed-iteration updates: max relative factor error after 50 updates
# (20 for IS).  Convergence fits: iterate error at the device's own
# stopping iteration, and stopping drift in iterations (one
# check_every=10 checkpoint for the beta and convolutive fits, whose
# log/reciprocal statistics are noisier than Frobenius).  Envelope:
# the float64 filter returned in float32.
UPDATE_TOL = 1e-3
FIT_TOL, FIT_GAP = 2e-3, 2
CHUNK_FIT_GAP = 10
ENVELOPE_TOL = 1e-4


def run_check(args):
    """Device numerics of the paths ``impl="auto"`` runs on this device."""
    import jax
    import jax.numpy as jnp

    from muscle_synergies_tpu import reference as ref
    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.models import batch as mb
    from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch
    from muscle_synergies_tpu.testing import gait_emg_array
    from muscle_synergies_tpu.utils.config import PipelineConfig

    rng = np.random.default_rng(0)
    b, n, l, k, iters = 128, 200, 8, 4, 50
    if args.quick:
        b, iters = 16, 20
    x = rng.random((b, n, l)).astype(np.float32)
    x_pos = x + np.float32(0.05)  # Itakura-Saito needs positive data
    w0 = np.abs(rng.standard_normal((b, n, k))).astype(np.float32)
    h0 = np.abs(rng.standard_normal((b, k, l))).astype(np.float32)
    xs, xps, ws, hs = map(jnp.asarray, (x, x_pos, w0, h0))
    is_iters = min(iters, 20)

    updates = {
        "mu": (mb.mu_iterations_batch(xs, ws, hs, iters, impl="auto"),
               lambda i: ref.mu_iterations(x[i], w0[i], h0[i], iters)),
        "cd": (mb.cd_iterations_batch(xs, ws, hs, iters, impl="auto"),
               lambda i: ref.cd_iterations(x[i], w0[i], h0[i], iters)),
        "kl": (mb.beta_mu_iterations_batch(
                   xs, ws, hs, iters, beta=1.0, impl="auto"),
               lambda i: ref.kl_iterations(x[i], w0[i], h0[i], iters)),
        "is": (mb.beta_mu_iterations_batch(
                   xps, ws, hs, is_iters, beta=0.0, impl="auto"),
               lambda i: ref.is_iterations(
                   x_pos[i], w0[i], h0[i], is_iters)),
        "beta1.5": (mb.beta_mu_iterations_batch(
                        xs, ws, hs, iters, beta=1.5, impl="auto"),
                    lambda i: ref.beta_iterations(
                        x[i], w0[i], h0[i], iters, 1.5)),
    }
    update_errs = {
        name: _max_factor_error(*dev, ref_fn, b)
        for name, (dev, ref_fn) in updates.items()
    }

    fit_iter = 200 if not args.quick else 50
    kw = dict(max_iter=fit_iter, tol=1e-4)
    fits = {}
    st = mb.fit_mu_batch(xs, ws, hs, impl="auto", **kw)
    fits["fitmu"] = _fit_error(
        st.w, st.h, st.n_iter,
        lambda i: ref.fit_mu(x[i], w0[i], h0[i], **kw), b,
    ) + (FIT_GAP,)
    st = mb.fit_cd_batch(xs, ws, hs, impl="auto", **kw)
    n_dev = np.asarray(st.n_iter, dtype=np.int64)
    w_ref, h_ref, n_ref = ref.fit_cd_stack(
        x, w0, h0, stop_at=n_dev, max_gap=FIT_GAP, **kw
    )
    fits["fitcd"] = (
        _max_factor_error(st.w, jnp.swapaxes(st.ht, -1, -2),
                          lambda i: (w_ref[i], h_ref[i]), b),
        int(np.max(np.where(n_ref < 0, FIT_GAP + 1,
                            np.abs(n_dev - n_ref)))),
        FIT_GAP,
    )
    for name, beta, xf, xf_dev in (
        ("fitkl", 1.0, x, xs), ("fitis", 0.0, x_pos, xps),
    ):
        st = mb.fit_mu_beta_batch(
            xf_dev, ws, hs, beta=beta, impl="auto", **kw
        )
        fits[name] = _fit_error(
            st.w, st.h, st.n_iter,
            lambda i, xf=xf, beta=beta: ref.fit_beta(
                xf[i], w0[i], h0[i], beta, **kw),
            b,
        ) + (CHUNK_FIT_GAP,)
    d_lags = 6
    c0 = rng.uniform(0.1, 1.0, (b, n, k)).astype(np.float32)
    s0 = rng.uniform(0.1, 1.0, (b, k, d_lags, l)).astype(np.float32)
    x_cn = rng.uniform(0.1, 1.0, (b, n, l)).astype(np.float32)
    st = fit_cnmf_batch(
        jnp.asarray(x_cn), jnp.asarray(c0), jnp.asarray(s0),
        precision="highest", **kw,
    )
    fits["fitcnmf"] = _fit_error(
        st.c, st.s, st.n_iter,
        lambda i: ref.fit_cnmf(x_cn[i], c0[i], s0[i], **kw), b,
    ) + (CHUNK_FIT_GAP,)

    # the dataset preprocessing (float64 envelope filter) vs scipy
    n_sig = 8192 if args.quick else 124_460
    trials = [gait_emg_array(n_samples=n_sig, seed=s) for s in range(2)]
    cfg = PipelineConfig()
    env = np.asarray(preprocess_trials(trials, 2000.0, cfg))
    env_err = max(
        float(np.max(np.abs(env[i] - r)) / np.max(np.abs(r)))
        for i, r in enumerate(
            ref.preprocess(t, 2000.0, cfg) for t in trials
        )
    )

    ok = (
        all(e <= UPDATE_TOL for e in update_errs.values())
        and all(e <= FIT_TOL and g <= gmax for e, g, gmax in fits.values())
        and env_err <= ENVELOPE_TOL
    )
    worst = max(max(update_errs.values()), env_err)
    _emit({
        "metric": "solver_parity_max_rel_err",
        "value": float(f"{worst:.3e}"),
        "unit": (
            " ".join(f"{s}={e:.2e}" for s, e in update_errs.items())
            + f" (tol {UPDATE_TOL:g}), "
            + " ".join(
                f"{s}={e:.2e}/gap{g}" for s, (e, g, _) in fits.items()
            )
            + f" (tol {FIT_TOL:g}/gap{FIT_GAP}, beta+cnmf gap"
            f"{CHUNK_FIT_GAP}), envelope={env_err:.2e} "
            f"(tol {ENVELOPE_TOL:g}), impl=auto on "
            f"{jax.default_backend()}"
        ),
        "vs_baseline": 1.0 if ok else 0.0,
        "date": _utc_date(),
    })
    return 0 if ok else 1


def main(argv=None):
    args = _parse_args(argv)
    if args.metric == "vaf" and args.solver in ("cnmf", "nm3f"):
        raise SystemExit(
            "--metric vaf measures the plain-NMF time-to-VAF "
            "problem; it supports --solver mu/cd/kl/is only"
        )
    if args.solver in ("cnmf", "nm3f") and args.impl == "pallas":
        raise SystemExit(
            f"--solver {args.solver} has no Pallas kernel; use --impl "
            "auto or xla"
        )
    _require_device()
    from muscle_synergies_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    if args.quick:
        args.batch, args.iters, args.repeats = 32, 50, 3
    if args.check:
        return run_check(args)
    if args.metric == "vaf":
        return run_vaf(args)
    if args.metric == "fit":
        return run_fit(args)
    return run_iters(args)


if __name__ == "__main__":
    sys.exit(main())
