"""Plain float64 host references for the solvers (numpy only).

Straightforward loop implementations of sklearn's update and stopping
rules for every solver family, written independently of the JAX code
under test.  The device paths are compared against them:
``bench.py --check``, ``chip_smoke.py`` and the tests.

The ``*_iterations`` functions run a fixed number of updates; the
``fit_*`` functions add the family's stopping rule and return
``(snapshots, n_iter)`` (:func:`fit_cd_stack` instead runs a stack of
trials to given stopping iterations, for CD's long fits): the float64 iterates at every iteration count
where a device fit could stop, and the iteration at which the
reference's own rule fires.  Comparing a device fit against the
snapshot at the *device's* stopping iteration measures iterate
accuracy, which stays well-posed when a near-threshold float32
stopping decision flips by one checkpoint; the stopping drift
``|n_device - n_iter|`` is reported separately.
"""

from __future__ import annotations

import numpy as np

# sklearn's EPSILON (float32 eps), the zero-denominator guard
EPSILON = 1.1920929e-07

__all__ = [
    "EPSILON",
    "mu_iterations",
    "cd_iterations",
    "kl_iterations",
    "is_iterations",
    "beta_iterations",
    "cnmf_iterations",
    "cnmf_reconstruct",
    "beta_divergence",
    "fit_mu",
    "fit_cd_stack",
    "fit_beta",
    "fit_cnmf",
    "fit_nm3f",
    "vaf",
    "factor_error",
    "preprocess",
]


def mu_iterations(x, w, h, iters):
    """float64 host reference of the MU iteration (sklearn semantics)."""
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    for _ in range(iters):
        den = w @ (h @ h.T)
        w = w * ((x @ h.T) / np.where(den == 0, EPSILON, den))
        den = (w.T @ w) @ h
        h = h * ((w.T @ x) / np.where(den == 0, EPSILON, den))
    return w, h


def kl_iterations(x, w, h, iters):
    """float64 host reference of the KL MU iteration (sklearn semantics)."""
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    f64_eps = np.finfo(np.float64).eps
    for _ in range(iters):
        quot = x / np.maximum(w @ h, EPSILON)
        den = h.sum(axis=1)
        w = w * ((quot @ h.T) / np.where(den == 0, EPSILON, den)[None, :])
        quot = x / np.maximum(w @ h, EPSILON)
        w_sum = w.sum(axis=0)
        w_sum = np.where(w_sum == 0, 1.0, w_sum)
        h = h * ((w.T @ quot) / w_sum[:, None])
        h[h < f64_eps] = 0.0
    return w, h


def beta_iterations(x, w, h, iters, beta):
    """float64 host reference of the generic-beta MU iteration.

    sklearn's ``_multiplicative_update_w/_h`` for an arbitrary float
    ``beta_loss``: numerator ``X*(WH)^(beta-2)`` (clamped for beta<2),
    denominator ``(WH)^(beta-1)`` (clamped for beta<1), gamma damping,
    and the beta<1 / beta<=1 stability flushes.
    """
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    f64_eps = np.finfo(np.float64).eps
    if beta < 1.0:
        gamma = 1.0 / (2.0 - beta)
    elif beta > 2.0:
        gamma = 1.0 / (beta - 1.0)
    else:
        gamma = 1.0
    for _ in range(iters):
        wh = w @ h
        whn = np.maximum(wh, EPSILON) if beta < 2.0 else wh
        whd = np.maximum(wh, EPSILON) if beta < 1.0 else wh
        num = (x * whn ** (beta - 2.0)) @ h.T
        den = whd ** (beta - 1.0) @ h.T
        den[den == 0] = EPSILON
        delta = num / den
        if gamma != 1.0:
            delta = delta**gamma
        w = w * delta
        if beta < 1.0:
            w[w < f64_eps] = 0.0
        wh = w @ h
        whn = np.maximum(wh, EPSILON) if beta < 2.0 else wh
        whd = np.maximum(wh, EPSILON) if beta < 1.0 else wh
        num = w.T @ (x * whn ** (beta - 2.0))
        den = w.T @ whd ** (beta - 1.0)
        den[den == 0] = EPSILON
        delta = num / den
        if gamma != 1.0:
            delta = delta**gamma
        h = h * delta
        if beta <= 1.0:
            h[h < f64_eps] = 0.0
    return w, h


def cnmf_iterations(x, c, s, iters):
    """float64 host reference of the convolutive MU iteration.

    The Smaragdis-style update of ``models.cnmf.cnmf_update`` in plain
    numpy: per-lag S projections against causally shifted activations,
    then the ratio-of-sums C update with the fresh S.
    """
    x = x.astype(np.float64)
    c = c.astype(np.float64)
    s = s.astype(np.float64)
    t = c.shape[0]
    n_lags = s.shape[1]

    def shift_down(m, d):
        if d == 0:
            return m
        out = np.zeros_like(m)
        out[d:] = m[: t - d]
        return out

    def shift_up(m, d):
        if d == 0:
            return m
        out = np.zeros_like(m)
        out[: t - d] = m[d:]
        return out

    def reconstruct(cm, sm):
        return sum(
            shift_down(cm, d) @ sm[:, d, :] for d in range(n_lags)
        )

    for _ in range(iters):
        cs = [shift_down(c, d) for d in range(n_lags)]
        xhat = reconstruct(c, s)
        s_new = s.copy()
        for d in range(n_lags):
            num = cs[d].T @ x
            den = cs[d].T @ xhat
            den[den == 0] = EPSILON
            s_new[:, d, :] = s[:, d, :] * (num / den)
        s = s_new
        xhat = reconstruct(c, s)
        num = np.zeros_like(c)
        den = np.zeros_like(c)
        for d in range(n_lags):
            num += shift_up(x @ s[:, d, :].T, d)
            den += shift_up(xhat @ s[:, d, :].T, d)
        den[den == 0] = EPSILON
        c = c * (num / den)
    return c, s


def cd_iterations(x, w, h, iters):
    """float64 host reference of the CD/HALS outer iteration.

    sklearn ``_update_coordinate_descent`` with ``shuffle=False``: a
    cyclic Newton pass over W's components (H fixed), then the same
    pass over Ht via X.T — the update order of
    ``muscle_synergies_tpu.models.hals.fit_cd`` and the CD kernel.
    """
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    ht = h.astype(np.float64).T  # (L, k)

    def cd_pass(xm, wm, htm):
        hht = htm.T @ htm
        xht = xm @ htm
        for s in range(htm.shape[1]):
            grad = wm @ hht[:, s] - xht[:, s]
            hess = hht[s, s]
            if hess != 0:
                wm[:, s] = np.maximum(wm[:, s] - grad / hess, 0.0)
        return wm

    for _ in range(iters):
        w = cd_pass(x, w, ht)
        ht = cd_pass(x.T, ht, w)
    return w, ht.T


def fit_mu(x, w, h, max_iter=200, tol=1e-4, check_every=10):
    """float64 host reference of the full MU convergence fit.

    The update of :func:`mu_iterations` plus the exact stopping
    rule of ``models.mu.fit_mu`` (sklearn semantics): every
    ``check_every`` iterations compute the Frobenius error and stop
    when ``(prev - err) / err_init < tol``.

    Returns ``(snapshots, n_iter)`` with the checkpoint-snapshot
    contract of :func:`fit_beta`: snapshots at every
    possible device stop point (checkpoint multiples plus
    ``max_iter``), ``n_iter`` where the rule first fires.
    """
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    err_init = np.linalg.norm(x - w @ h)
    prev = err_init
    n_iter = None
    snapshots = {0: (w, h)}
    for it in range(1, max_iter + 1):
        den = w @ (h @ h.T)
        w = w * ((x @ h.T) / np.where(den == 0, EPSILON, den))
        den = (w.T @ w) @ h
        h = h * ((w.T @ x) / np.where(den == 0, EPSILON, den))
        if it % check_every == 0 or it == max_iter:
            snapshots[it] = (w, h)
        if tol > 0 and it % check_every == 0 and n_iter is None:
            err = np.linalg.norm(x - w @ h)
            if (prev - err) / err_init < tol:
                n_iter = it
            prev = err
    if n_iter is None:
        n_iter = max_iter
    return snapshots, n_iter


def _cd_pass_stack(x, w, ht):
    """:func:`cd_iterations`' coordinate pass over a stack of trials."""
    hht = np.einsum("blk,blj->bkj", ht, ht)
    xht = np.einsum("bnl,blk->bnk", x, ht)
    violation = np.zeros(x.shape[0])
    for s in range(ht.shape[2]):
        grad = np.einsum("bnk,bk->bn", w, hht[:, :, s]) - xht[:, :, s]
        pg = np.where(w[:, :, s] == 0.0, np.minimum(grad, 0.0), grad)
        violation += np.abs(pg).sum(axis=1)
        hess = hht[:, s, s]
        nonzero = hess != 0
        step = grad / np.where(nonzero, hess, 1.0)[:, None]
        w[:, :, s] = np.where(
            nonzero[:, None], np.maximum(w[:, :, s] - step, 0.0), w[:, :, s]
        )
    return w, violation


def fit_cd_stack(xs, ws, hs, stop_at, max_gap, max_iter=200, tol=1e-4):
    """The full CD convergence fit over a ``(B, N, L)`` stack at once.

    The pass of :func:`cd_iterations` with sklearn's stopping statistic
    (``models.hals.fit_cd`` semantics): the summed absolute projected
    gradient over both passes, converged when ``violation /
    violation_init <= tol`` with ``violation_init`` the first
    iteration's total.  Trials are independent, so the stack simply
    runs until every trial has reached its ``stop_at[i]`` (the device's
    stopping iteration) and either fired the rule or passed
    ``stop_at[i] + max_gap``: long fits stay cheap on the host.

    Returns:
        ``(w_at, h_at, n_iter)``: each trial's float64 iterates after
        ``stop_at[i]`` iterations, and where the reference stops (the
        rule firing, or ``max_iter``; ``-1`` where it had not stopped by
        ``stop_at[i] + max_gap``).
    """
    xs = np.asarray(xs, dtype=np.float64)
    w = np.array(ws, dtype=np.float64)
    ht = np.swapaxes(np.asarray(hs, dtype=np.float64), 1, 2).copy()
    stop_at = np.asarray(stop_at, dtype=np.int64)
    w_at, h_at = w.copy(), np.swapaxes(ht, 1, 2).copy()
    n_iter = np.full(len(xs), -1)
    violation_init = np.zeros(len(xs))
    xts = np.swapaxes(xs, 1, 2)
    for it in range(1, max_iter + 1):
        if it > stop_at.max() and np.all(
            (n_iter >= 0) | (it > stop_at + max_gap)
        ):
            break
        w, vw = _cd_pass_stack(xs, w, ht)
        ht, vh = _cd_pass_stack(xts, ht, w)
        violation = vw + vh
        if it == 1:
            violation_init = violation
        safe = np.where(violation_init == 0, 1.0, violation_init)
        fired = (n_iter < 0) & (
            (violation_init == 0) | (violation / safe <= tol)
        )
        n_iter[fired] = it
        at = stop_at == it
        w_at[at] = w[at]
        h_at[at] = np.swapaxes(ht[at], 1, 2)
    else:  # ran all of max_iter: the cap stops the rest
        n_iter[n_iter < 0] = max_iter
    return w_at, h_at, n_iter


def beta_divergence(x, w, h, beta):
    """float64 host twin of ``models.beta.beta_divergence`` (sqrt form).

    Reproduces sklearn's ``_beta_divergence`` semantics exactly as the
    device implementation does: data-dependent terms masked to
    ``x > EPSILON``, the Itakura-Saito constant counting *all* entries,
    and the final ``sqrt(2 * max(res, 0))``.
    """
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    wh = w @ h
    if beta == 2.0:
        return float(np.linalg.norm(x - wh))
    mask = x > EPSILON
    whc = np.maximum(wh, EPSILON)
    div = np.where(mask, x / whc, 1.0)
    if beta == 1.0:
        res = (
            np.sum(np.where(mask, x * np.log(div), 0.0))
            + w.sum(axis=0) @ h.sum(axis=1)
            - np.sum(np.where(mask, x, 0.0))
        )
    elif beta == 0.0:
        res = (
            np.sum(np.where(mask, div, 0.0))
            - x.size
            - np.sum(np.where(mask, np.log(div), 0.0))
        )
    else:
        sum_wh_beta = np.sum(wh**beta)
        sum_x_wh = np.sum(np.where(mask, x * whc ** (beta - 1.0), 0.0))
        res = np.sum(np.where(mask, x**beta, 0.0)) - beta * sum_x_wh
        res = (res + sum_wh_beta * (beta - 1.0)) / (beta * (beta - 1.0))
    return float(np.sqrt(2.0 * max(res, 0.0)))


def fit_beta(
    x, w, h, beta, max_iter=200, tol=1e-4, check_every=10
):
    """float64 host reference of the full beta-divergence fit.

    The per-iteration updates of :func:`kl_iterations` /
    :func:`is_iterations` / :func:`beta_iterations` plus the
    exact stopping rule of ``models.beta.fit_mu_beta`` (and of the
    chunked kernel path ``models.batch._fit_beta_batch_pallas``): every
    ``check_every`` iterations compute ``sqrt(2 * divergence)`` and
    stop when ``(prev - err) / err_init < tol``.

    Returns ``(snapshots, n_iter)``: ``snapshots`` maps every
    checkpoint iteration count (multiples of ``check_every`` up to
    ``max_iter``, plus ``max_iter`` itself if a tail remains) to its
    float64 ``(w, h)`` iterates, and ``n_iter`` is where the fit's own
    stopping rule first fires.  Keeping all checkpoints lets callers
    compare a device fit's factors against the f64 iterates *at the
    device's own stopping iteration* — the well-posed comparison when
    an f32 near-threshold stopping decision flips by one checkpoint
    (the iterates past a stop are unaffected by the stopping decision,
    so later snapshots equal a no-stop run of that length).
    """
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)

    def step(w, h, iters):
        if beta == 1.0:
            return kl_iterations(x, w, h, iters)
        if beta == 0.0:
            return is_iterations(x, w, h, iters)
        return beta_iterations(x, w, h, iters, beta)

    err_init = beta_divergence(x, w, h, beta)
    prev = err_init
    n_iter = None
    snapshots = {0: (w, h)}
    n = 0
    n_full = (max_iter // check_every) * check_every
    while n < n_full:
        w, h = step(w, h, check_every)
        n += check_every
        snapshots[n] = (w, h)
        if n_iter is None:
            err = beta_divergence(x, w, h, beta)
            if err_init == 0.0 or (prev - err) / err_init < tol:
                n_iter = n
            prev = err
    if max_iter > n_full:  # unchecked tail chunk, like the device path
        w, h = step(w, h, max_iter - n_full)
        snapshots[max_iter] = (w, h)
    if n_iter is None:
        n_iter = max_iter
    return snapshots, n_iter


def cnmf_reconstruct(c, s):
    """float64 convolutive reconstruction ``Σ_d shift_down(C, d) @ S_d``."""
    t = c.shape[0]
    out = np.zeros((t, s.shape[2]), dtype=np.float64)
    for d in range(s.shape[1]):
        shifted = np.zeros_like(c)
        shifted[d:] = c[: t - d]
        out += shifted @ s[:, d, :]
    return out


def fit_cnmf(x, c, s, max_iter=200, tol=1e-4, check_every=10):
    """float64 host reference of the full convolutive fit.

    The update of :func:`cnmf_iterations` plus the exact stopping
    rule of ``models.cnmf.fit_cnmf``:
    every ``check_every`` iterations compute the Frobenius error and
    stop when ``(prev - err) / max(err_init, EPSILON) < tol``.

    Returns ``(snapshots, n_iter)`` with the same checkpoint-snapshot
    contract as :func:`fit_beta` (the device fit checks only at
    multiples of ``check_every`` and may overshoot ``max_iter`` by up to
    one chunk; snapshots cover that final checkpoint too).
    """
    x = x.astype(np.float64)
    c = c.astype(np.float64)
    s = s.astype(np.float64)
    err_init = float(np.linalg.norm(x - cnmf_reconstruct(c, s)))
    prev = err_init
    n_iter = None
    snapshots = {0: (c, s)}
    n = 0
    n_last = ((max_iter + check_every - 1) // check_every) * check_every
    while n < n_last:
        c, s = cnmf_iterations(x, c, s, check_every)
        n += check_every
        snapshots[n] = (c, s)
        if n_iter is None:
            err = float(np.linalg.norm(x - cnmf_reconstruct(c, s)))
            if (prev - err) / max(err_init, EPSILON) < tol:
                n_iter = n
            prev = err
    if n_iter is None:
        n_iter = n_last
    return snapshots, n_iter


def is_iterations(x, w, h, iters):
    """float64 host reference of the Itakura-Saito MU iteration."""
    x = x.astype(np.float64)
    w = w.astype(np.float64)
    h = h.astype(np.float64)
    f64_eps = np.finfo(np.float64).eps
    for _ in range(iters):
        inv = 1.0 / np.maximum(w @ h, EPSILON)
        den = inv @ h.T
        den[den == 0] = EPSILON
        w = w * np.sqrt(((x * inv * inv) @ h.T) / den)
        w[w < f64_eps] = 0.0
        inv = 1.0 / np.maximum(w @ h, EPSILON)
        den = w.T @ inv
        den[den == 0] = EPSILON
        h = h * np.sqrt((w.T @ (x * inv * inv)) / den)
        h[h < f64_eps] = 0.0
    return w, h


def factor_error(w_dev, h_dev, w_ref, h_ref):
    """Max relative error of device factors vs float64 references."""
    return max(
        np.max(np.abs(w_dev - w_ref)) / np.max(np.abs(w_ref)),
        np.max(np.abs(h_dev - h_ref)) / np.max(np.abs(h_ref)),
    )


def nm3f_iterations(xs, w, a, s, iters):
    """float64 host reference of the space-by-time (NM3F) update.

    ``models.nm3f.nm3f_update`` in plain numpy: the per-trial
    coefficients ``A`` first, then the shared temporal modules ``W``,
    then the shared spatial modules ``S`` (with the refreshed ``W``).
    """
    xs = xs.astype(np.float64)
    w = w.astype(np.float64)
    a = a.astype(np.float64)
    s = s.astype(np.float64)
    for _ in range(iters):
        wtw, sst = w.T @ w, s @ s.T
        num = np.einsum("tp,btl,ql->bpq", w, xs, s)
        den = np.einsum("pr,brm,mq->bpq", wtw, a, sst)
        a = a * (num / np.where(den == 0, EPSILON, den))
        num = np.einsum("btl,ql,bpq->tp", xs, s, a)
        den = w @ np.einsum("bpq,qm,brm->pr", a, sst, a)
        w = w * (num / np.where(den == 0, EPSILON, den))
        wtw = w.T @ w
        num = np.einsum("bpq,tp,btl->ql", a, w, xs)
        den = np.einsum("bpq,pr,brm->qm", a, wtw, a) @ s
        s = s * (num / np.where(den == 0, EPSILON, den))
    return w, a, s


def _nm3f_error(xs, w, a, s):
    rec = np.einsum("tp,bpq,ql->btl", w, a, s)
    return float(np.linalg.norm(xs - rec))


def fit_nm3f(xs, w, a, s, max_iter=200, tol=1e-4, check_every=10):
    """float64 host reference of the space-by-time convergence fit.

    :func:`nm3f_iterations` in chunks of ``check_every`` with the
    stopping rule of ``models.nm3f.fit_nm3f``: stop when
    ``(prev - err) / max(err_init, EPSILON) < tol``.  Same
    ``(snapshots, n_iter)`` contract as :func:`fit_cnmf`, with
    ``(w, a, s)`` snapshots.
    """
    xs = xs.astype(np.float64)
    err_init = _nm3f_error(xs, w, a, s)
    prev = err_init
    n_iter = None
    snapshots = {0: (w, a, s)}
    n = 0
    n_last = ((max_iter + check_every - 1) // check_every) * check_every
    while n < n_last:
        w, a, s = nm3f_iterations(xs, w, a, s, check_every)
        n += check_every
        snapshots[n] = (w, a, s)
        if n_iter is None:
            err = _nm3f_error(xs, w, a, s)
            if (prev - err) / max(err_init, EPSILON) < tol:
                n_iter = n
            prev = err
    if n_iter is None:
        n_iter = n_last
    return snapshots, n_iter


def vaf(x, w, h):
    """Overall VAF ``1 - ||X - WH||^2 / ||X||^2`` in float64."""
    x = x.astype(np.float64)
    err = x - w.astype(np.float64) @ h.astype(np.float64)
    return 1.0 - float(np.sum(err * err)) / float(np.sum(x * x))


def preprocess(x, sampling_frequency, config):
    """float64 host twin of one trial through ``preprocess_trials``.

    scipy and numpy only: zero-center, then either the moving RMS
    (``np.convolve`` 'same' box window) or rectify + scipy
    ``sosfiltfilt`` with the config's envelope filter, then linear
    resampling onto ``config.reduce_to`` points and the optional
    per-channel max-abs normalization.
    """
    from scipy import signal as sps

    x = np.asarray(x, dtype=np.float64)
    if config.zero_center:
        x = x - x.mean(axis=0)
    if config.use_rms:
        window = int(round(config.rms_window_s * sampling_frequency))
        kernel = np.ones(window) / window
        y = np.sqrt(np.stack(
            [np.convolve(c * c, kernel, "same") for c in x.T], axis=1
        ))
    else:
        spec = config.envelope
        if spec.filter_type != "butter" or not spec.zero_lag:
            raise NotImplementedError("the twin covers zero-lag Butterworth")
        freqs = (
            spec.critical_freqs[0] if len(spec.critical_freqs) == 1
            else list(spec.critical_freqs)
        )
        sos = sps.butter(
            spec.order, freqs, btype=spec.band_type, fs=sampling_frequency,
            output="sos",
        )
        y = sps.sosfiltfilt(sos, np.abs(x), axis=0)
    src = np.linspace(0.0, 1.0, y.shape[0])
    dst = np.linspace(0.0, 1.0, config.reduce_to)
    y = np.stack([np.interp(dst, src, c) for c in y.T], axis=1)
    if config.amplitude_normalize:
        y = np.abs(y)
        denom = y.max(axis=0, keepdims=True)
        y = y / np.where(denom == 0, 1.0, denom)
    return y
