#!/usr/bin/env python
"""Smoke run of the dataset path on one GPU, with its numerics checked.

Run from the root of a checkout, in one process that owns the card::

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --chips 4    # only the sharded path, on 4 cards

Phases (one result line each, in order; any failure ends the run with a
non-zero exit and no final line):

1. device      the default backend must be a GPU; prints the card's name
               and power limit (nvidia-smi), the JAX version and
               ``XLA_FLAGS``.
2. ingest      writes 8 seeded full-size Vicon captures (about 124,460
               EMG samples x 8 channels at 2 kHz, two 9-channel force
               plates, 40 markers at 100 Hz) and loads them through the
               native decoder; the EMG read back must equal what was
               written.
3. preprocess  ``preprocess_trials`` with the default envelope and with
               the moving RMS; one full trial against scipy in float64.
4. solve       ``python -m muscle_synergies_tpu analyze-dataset`` run
               in-process on the 8 files, ranks 1..10 at the
               ``PipelineConfig`` defaults (cd, tol 1e-6, max_iter 100k),
               then with ``--solver mu``; then ``analyze_dataset`` on a
               1024-trial calibrated-gait batch (200 x 8, rank 4), 16
               trials against float64 host fits from the same init.
5. families    ``--time-varying 10`` (cNMF) and ``--space-by-time 3:2``
               (NM3F) on the same files, and both families' fits against
               float64 host fits at the default precision and at
               ``precision="highest"``.
6. kernels     every Triton kernel at 1024 x 200 x 8, rank 4, against the
               XLA path and float64, and timed warm against XLA (median
               of 5 runs, each ended by ``block_until_ready``).
7. serve       the transforms of a fitted NMFModel, CNMFModel and
               NM3FModel exported for cuda and cpu, reloaded (through
               bytes where the flatbuffers package is installed) and
               compared with the live models, one with a symbolic batch
               at two batch sizes.

``--chips 4`` runs the phase-4 dataset (at the CLI's ``analyze-dataset``
defaults: ranks 1..4, cd, tol 1e-6, max_iter 10k) on a 2 x 2
``(data, time)`` mesh with ``mesh=``, and ``sharded_fit_mu``/
``sharded_fit_cd``/``sharded_fit_cnmf``, each against the single-card
result.

Tolerances (float32 on the device against float64 on the host; factor
errors are max |dev - ref| / max |ref| per factor, fits compared at the
device's own stopping iteration, see :mod:`muscle_synergies_tpu.reference`):
see ``TOLERANCES`` below, printed beside each result.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# family -> (tolerance, precision it runs at, reason)
TOLERANCES = {
    "envelope": (
        1e-4, "float64 filter, float32 result",
        "the envelope lowpass runs in float64 on the device; the float32 "
        "result rounds at ~1e-7 and resampling adds ~1e-6",
    ),
    "rms": (
        1e-4, "float32 with a compensated running sum",
        "the double-float cumulative sum keeps window sums accurate "
        "relative to the window; float32 squares and sqrt add ~1e-6",
    ),
    "mu": (
        2e-3, "float32, exact multiply-adds (kernel and XLA at highest)",
        "iterates of a float32 fit drift from float64 by rounding "
        "amplified over hundreds of multiplicative updates",
    ),
    "cd": (
        2e-3, "float32, exact multiply-adds (kernel and XLA at highest)",
        "as MU; each coordinate step divides by a Gram diagonal",
    ),
    "kl": (
        2e-3, "float32 updates, divergence check at highest",
        "the KL quotient X/WH and its log-based stopping statistic are "
        "noisier than Frobenius",
    ),
    "is": (
        2e-3, "float32 updates, divergence check at highest",
        "as KL, with second-power reciprocals of WH",
    ),
    "cnmf": (
        2e-3, "float32 lag-stacked einsums",
        "ten-lag contractions accumulate rounding in the convolutive "
        "reconstruction",
    ),
    "nm3f": (
        2e-3, "float32 trilinear einsums",
        "coefficient, temporal and spatial updates each sum over the "
        "whole batch",
    ),
    "vaf": (
        1e-4, "float32",
        "overall VAF is a ratio of sums of squares; one part in 1e4 "
        "separates ranks far below any rank-selection threshold",
    ),
    "serve": (
        1e-5, "the exported program is the live model's program",
        "the same StableHLO runs; only the caller differs",
    ),
    "shard": (
        2e-3, "float32, psums over the time axis",
        "sharded sums reorder float32 additions across cards",
    ),
}
# Stopping drift allowed against the float64 fit, in iterations.  A
# float32 fit stops where its own relative improvement crosses tol, and
# near the threshold rounding moves that crossing.  Read on an H100 at
# the phase-6 shape (192 trials, 3 seeds, tol 1e-4), kernel / XLA
# (full-precision products) worst |gap|: MU 0 / 0, CD 2 / 2, KL 20 /
# 30, IS 10 / 10; the checkpointed fits move in steps of 10.  Each
# limit is the worse reading plus one checkpoint (CD: 5x its reading).
MAX_GAP = {"mu": 10, "cd": 10, "kl": 40, "is": 20, "cnmf": 10, "nm3f": 10}
# At tol 1e-6 (the PipelineConfig default) CD stops when its summed
# projected gradient has fallen six to seven decades below the first
# iteration's: the last digits float32 resolves, where the ratio creeps
# across the threshold and rounding moves the crossing by a fraction of
# the run.  On an H100, over the 32 distinct trials of the gait batch,
# the CD kernel stopped at most 4.7% (median 0.35%) of the run from the
# float64 fit, the XLA CD fit in float32 at full precision at most 22%
# (median 1.0%), and the XLA CD fit in float64 on the card exactly where
# the host did.  The drift is float32's; the limit is twice the
# kernel's worst reading.
CD_TIGHT_GAP = 0.10

GAIT_CONFIG = dict(
    use_rms=True, rms_window_s=0.5, reduce_to=200, amplitude_normalize=True,
    zero_center=True,
)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes; ``FULL`` is what a gait lab runs."""

    n_files: int = 8
    state_len: int = 3036  # 41 support states -> ~124,460 samples
    n_markers: int = 40
    ranks: tuple = tuple(range(1, 11))
    max_iter: int = 100_000
    tol: float = 1e-6
    gait_trials: int = 1024
    gait_distinct: int = 32
    gait_samples: int = 20_000
    n_check: int = 16
    batch: tuple = (1024, 200, 8)
    rank: int = 4
    lags: int = 10
    family_trials: int = 4
    repeats: int = 5


FULL = Sizes()


class SmokeError(RuntimeError):
    """A phase produced a wrong or malformed result."""


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeError(message)


def _within(name: str, family: str, err: float) -> str:
    tol = TOLERANCES[family][0]
    _check(np.isfinite(err) and err <= tol,
           f"{name}: error {err:.3e} above tolerance {tol:g}")
    return f"{name} {err:.2e} (tol {tol:g})"


def _median_seconds(fn, repeats: int) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------- phase 1
def phase_device(count: int) -> str:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            "chip_smoke.py needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r}"
        )
    _check(len(jax.devices()) >= count,
           f"{count} GPUs asked for, {len(jax.devices())} present")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"device: jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"{len(jax.devices())} x {jax.devices()[0].device_kind}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_ingest(sz: Sizes, workdir: str, seed: int):
    """Write the captures, load them back; returns ``(paths, emgs, fs)``."""
    from muscle_synergies_tpu import load_vicon_file, native
    from muscle_synergies_tpu.testing import (
        GAIT_MUSCLES,
        gait_emg_array,
        write_synthetic_capture,
    )

    _check(native.load_decoder() is not None,
           "the native CSV decoder did not build")
    paths = [os.path.join(workdir, f"capture_{i}.csv")
             for i in range(sz.n_files)]
    t0 = time.perf_counter()
    for i, path in enumerate(paths):
        write_synthetic_capture(
            path, state_len=sz.state_len, n_markers=sz.n_markers,
            seed=seed + i,
        )
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    caps = [load_vicon_file(p) for p in paths]
    load_s = time.perf_counter() - t0
    emgs = [c.emg for c in caps]
    fs = emgs[0].sampling_frequency
    for i, cap in enumerate(caps):
        n = cap.emg.array.shape[0]
        _check(cap.emg.array.shape == (n, len(GAIT_MUSCLES)),
               f"capture {i}: EMG shape {cap.emg.array.shape}")
        _check(len(cap.forcepl) == 2
               and all(p.array.shape == (n, 9) for p in cap.forcepl),
               f"capture {i}: force plates malformed")
        _check(len(cap.traj) == sz.n_markers,
               f"capture {i}: {len(cap.traj)} markers")
        written = np.round(gait_emg_array(n, fs, seed=seed + i), 6)
        err = float(np.max(np.abs(cap.emg.array - written)))
        _check(err <= 1e-6, f"capture {i}: EMG read back off by {err:.2e}")
    nbytes = sum(os.path.getsize(p) for p in paths)
    rows = sum(c.emg.array.shape[0] for c in caps)
    print(f"ingest: {len(paths)} files, {nbytes} bytes, {rows} EMG rows "
          f"({emgs[0].array.shape[0]} x {emgs[0].array.shape[1]} at "
          f"{fs:g} Hz each), written in {write_s:.2f} s, loaded in "
          f"{load_s:.2f} s ({nbytes / load_s / 1e6:.1f} MB/s, native "
          "decoder)")
    return paths, emgs, fs


# ---------------------------------------------------------------- phase 3
def phase_preprocess(emgs, fs) -> None:
    from muscle_synergies_tpu import reference as ref
    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.utils.config import PipelineConfig

    parts = []
    for family, cfg in (("envelope", PipelineConfig()),
                        ("rms", PipelineConfig(use_rms=True))):
        t0 = time.perf_counter()
        xs = np.asarray(preprocess_trials(emgs, fs, cfg))
        secs = time.perf_counter() - t0
        _check(xs.shape == (len(emgs), cfg.reduce_to, emgs[0].array.shape[1])
               and np.all(np.isfinite(xs)),
               f"{family}: preprocessed batch {xs.shape} malformed")
        want = ref.preprocess(emgs[0].array, fs, cfg)
        err = float(np.max(np.abs(xs[0] - want)) / np.max(np.abs(want)))
        parts.append(_within(family, family, err) + f" in {secs:.2f} s")
    print("preprocess: " + "; ".join(parts))


# ---------------------------------------------------------------- phase 4
def _cli(argv):
    from muscle_synergies_tpu.__main__ import main

    rc = main(argv)
    _check(rc == 0, f"CLI {' '.join(argv[:2])} returned {rc}")


def _solve_files(sz: Sizes, paths, workdir, extra, label) -> None:
    out = os.path.join(workdir, f"{label}.json")
    lo, hi = sz.ranks[0], sz.ranks[-1]
    t0 = time.perf_counter()
    _cli(["analyze-dataset", *paths, "--ranks", f"{lo}:{hi}",
          "--max-iter", str(sz.max_iter), "--tol", f"{sz.tol:g}",
          "--output", out, *extra])
    secs = time.perf_counter() - t0
    with open(out) as fh:
        report = json.load(fh)
    vaf = np.array([[row[str(k)] for k in sz.ranks]
                    for row in report["vaf_overall"]])
    n_iter = np.asarray(report["n_iter"])
    _check(vaf.shape == (len(paths), len(sz.ranks))
           and np.all(np.isfinite(vaf)) and np.all(vaf <= 1.0)
           and np.all(vaf[:, -1] > vaf[:, 0]),
           f"{label}: VAF table malformed: {vaf}")
    _check(np.all(n_iter >= 1), f"{label}: n_iter {n_iter}")
    print(f"solve {label}: {len(paths)} files x ranks {lo}..{hi} in "
          f"{secs:.2f} s; mean VAF rank {lo} {vaf[:, 0].mean():.4f}, "
          f"rank {hi} {vaf[:, -1].mean():.4f}; n_iter max "
          f"{int(n_iter.max())} mean {n_iter.mean():.0f}")


def gait_batch(sz: Sizes):
    """The calibrated gait regime, raw: ``gait_distinct`` seeded
    captures tiled to ``gait_trials`` trials (as ``bench.py --metric
    vaf`` builds it)."""
    from muscle_synergies_tpu.testing import gait_emg_array

    distinct = [gait_emg_array(n_samples=sz.gait_samples, seed=100 + i)
                for i in range(sz.gait_distinct)]
    return [distinct[i % sz.gait_distinct] for i in range(sz.gait_trials)]


def phase_solve(sz: Sizes, paths, workdir) -> None:
    from muscle_synergies_tpu import reference as ref
    from muscle_synergies_tpu.dataset import analyze_dataset, preprocess_trials
    from muscle_synergies_tpu.models.batch import init_batch
    from muscle_synergies_tpu.utils.config import PipelineConfig

    _solve_files(sz, paths, workdir, [], "cd")
    _solve_files(sz, paths, workdir, ["--solver", "mu"], "mu")

    cfg = PipelineConfig(**GAIT_CONFIG, max_iter=sz.max_iter, tol=sz.tol)
    trials = gait_batch(sz)
    t0 = time.perf_counter()
    res = analyze_dataset(trials, 2000.0, ranks=(sz.rank,), config=cfg)
    secs = time.perf_counter() - t0
    _check(np.all(np.isfinite(res.vaf_overall)), "gait batch: VAF not finite")
    # the same init analyze_dataset draws, for the host fits
    xs = preprocess_trials(trials[: sz.n_check], 2000.0, cfg)
    w0, h0 = init_batch(xs, sz.rank, seed=0)
    xs, w0, h0 = (np.asarray(a, dtype=np.float64) for a in (xs, w0, h0))
    n_dev = np.asarray(res.n_iter[0, : sz.n_check])
    w_ref, h_ref, n_ref = ref.fit_cd_stack(
        xs, w0, h0, stop_at=n_dev,
        max_gap=max(MAX_GAP["cd"], int(CD_TIGHT_GAP * n_dev.max())),
        max_iter=sz.max_iter, tol=sz.tol,
    )
    f_err = max(
        ref.factor_error(res.w[0, i, :, : sz.rank], res.h[0, i, : sz.rank],
                         w_ref[i], h_ref[i])
        for i in range(sz.n_check)
    )
    v_err = max(
        abs(float(res.vaf_overall[0, i]) - ref.vaf(xs[i], w_ref[i], h_ref[i]))
        for i in range(sz.n_check)
    )
    allowed = np.maximum(MAX_GAP["cd"], CD_TIGHT_GAP * n_dev).astype(int)
    ref_stop = np.where(n_ref < 0, n_dev + allowed + 1, n_ref)
    drift = np.abs(n_dev - ref_stop)
    worst = int(np.argmax(drift / allowed))
    gap = int(drift[worst])
    _check(np.all(drift <= allowed),
           f"gait batch: trial {worst} stopped at {int(n_dev[worst])}, "
           f"the float64 fit at {int(n_ref[worst])} (-1: not by "
           f"{int(n_dev[worst] + allowed[worst])})")
    n_iter = res.n_iter[0]
    print(f"solve gait batch: {len(trials)} trials x {cfg.reduce_to} x "
          f"{xs.shape[2]}, rank {sz.rank}, cd, in {secs:.2f} s; n_iter "
          f"max {int(n_iter.max())} mean {n_iter.mean():.0f}; "
          f"{sz.n_check} trials vs float64: "
          + _within("factors", "cd", f_err) + "; "
          + _within("VAF", "vaf", v_err)
          + f"; stopping gap {gap} at n_iter {int(n_dev[worst])} (max "
          f"{MAX_GAP['cd']} or {CD_TIGHT_GAP:g} of the run); float64 stops "
          f"at {np.sort(n_ref).tolist()}; mean VAF "
          f"{float(np.mean(res.vaf_overall)):.4f}")


# ---------------------------------------------------------------- phase 5
def phase_families(sz: Sizes, paths, emgs, fs, workdir) -> None:
    import jax.numpy as jnp

    from muscle_synergies_tpu import reference as ref
    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch, init_cnmf
    from muscle_synergies_tpu.models.nm3f import fit_nm3f, init_nm3f
    from muscle_synergies_tpu.utils.config import PipelineConfig

    for flag, value, label in (("--time-varying", str(sz.lags), "cnmf"),
                               ("--space-by-time", "3:2", "nm3f")):
        out = os.path.join(workdir, f"{label}.json")
        extra = ["--ranks", "3"] if label == "cnmf" else []
        t0 = time.perf_counter()
        _cli(["analyze-dataset", *paths, flag, value, *extra,
              "--output", out])
        with open(out) as fh:
            report = json.load(fh)
        vaf = np.atleast_1d(report["vaf_overall"])
        _check(np.all(np.isfinite(vaf)) and np.all(vaf <= 1.0),
               f"{label}: VAF {vaf}")
        print(f"families {label} CLI: {flag} {value} in "
              f"{time.perf_counter() - t0:.2f} s, mean VAF "
              f"{float(np.mean(vaf)):.4f}")

    xs = np.asarray(preprocess_trials(emgs, fs, PipelineConfig()))
    xs = xs[: sz.family_trials]
    kw = dict(max_iter=500, tol=1e-5)
    c0, s0 = init_cnmf(xs, 3, sz.lags, seed=0)
    w0, a0, m0 = init_nm3f(xs, 3, 2, seed=0)
    parts, checks = [], []
    # precision=None is the library default (full float32 products);
    # "highest" spells the same request explicitly
    for precision in (None, "highest"):
        label = precision or "default"
        st = fit_cnmf_batch(jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
                            precision=precision, **kw)
        err, gap = 0.0, 0
        for i in range(len(xs)):
            n_dev = int(st.n_iter[i])
            snaps, n_ref = ref.fit_cnmf(xs[i], c0[i], s0[i], **kw)
            n_key = min(n_dev, max(snaps))
            err = max(err, ref.factor_error(
                np.asarray(st.c[i]), np.asarray(st.s[i]), *snaps[n_key]))
            gap = max(gap, abs(n_dev - n_ref))
        parts.append(f"cnmf@{label} err {err:.2e} gap {gap}")
        checks.append((f"cnmf@{label}", "cnmf", err, gap))
        st = fit_nm3f(jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
                      jnp.asarray(m0), precision=precision, **kw)
        snaps, n_ref = ref.fit_nm3f(xs, w0, a0, m0, **kw)
        n_dev = int(st.n_iter)
        w_r, a_r, s_r = snaps[min(n_dev, max(snaps))]
        err = max(
            ref.factor_error(np.asarray(st.w), np.asarray(st.s), w_r, s_r),
            float(np.max(np.abs(np.asarray(st.a) - a_r)) / np.max(np.abs(a_r))),
        )
        gap = abs(n_dev - n_ref)
        parts.append(f"nm3f@{label} err {err:.2e} gap {gap}")
        checks.append((f"nm3f@{label}", "nm3f", err, gap))
    print("families vs float64: " + "; ".join(parts))
    for name, family, err, gap in checks:
        _within(name, family, err)
        _check(gap <= MAX_GAP[family], f"{name}: stopping gap {gap}")


# ---------------------------------------------------------------- phase 6
def kernel_problem(sz: Sizes, seed: int):
    """A synthetic low-rank batch at the benchmark shape."""
    rng = np.random.default_rng(seed)
    b, n, l = sz.batch
    x = (rng.random((b, n, 3)) @ rng.random((b, 3, l))
         + 0.05 * rng.random((b, n, l))).astype(np.float32)
    avg = float(np.sqrt(x.mean() / sz.rank))
    w0 = (avg * np.abs(rng.standard_normal((b, n, sz.rank)))).astype(np.float32)
    h0 = (avg * np.abs(rng.standard_normal((b, sz.rank, l)))).astype(np.float32)
    return x, w0, h0


def phase_kernels(sz: Sizes, seed: int, interpret: bool = False) -> list:
    """Each Triton kernel's fit against XLA and float64, timed warm.

    ``interpret=True`` runs the kernels in Pallas' interpreter (the CPU
    rehearsal); the chip run compiles them for the card.
    """
    import jax
    import jax.numpy as jnp

    from muscle_synergies_tpu import reference as ref
    from muscle_synergies_tpu.models import batch as mb

    x, w0, h0 = kernel_problem(sz, seed)
    x_pos = x + np.float32(0.05)
    kw = dict(max_iter=500, tol=1e-4)
    n_check = min(sz.n_check, x.shape[0])

    def fit(family, impl, xs):
        args = (jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(h0))
        opts = dict(impl=impl, interpret=interpret and impl == "pallas", **kw)
        if family == "mu":
            st = mb.fit_mu_batch(*args, **opts)
            return st.w, st.h, st.n_iter
        if family == "cd":
            st = mb.fit_cd_batch(*args, **opts)
            return st.w, jnp.swapaxes(st.ht, -1, -2), st.n_iter
        beta = 1.0 if family == "kl" else 0.0
        st = mb.fit_mu_beta_batch(*args, beta=beta, **opts)
        return st.w, st.h, st.n_iter

    def ref_at(family, xs, n_dev):
        """float64 factors at each trial's ``n_dev`` and the host stop."""
        if family == "cd":
            w_r, h_r, n_ref = ref.fit_cd_stack(
                xs[:n_check], w0[:n_check], h0[:n_check], stop_at=n_dev,
                max_gap=MAX_GAP["cd"], **kw,
            )
            n_ref = np.where(n_ref < 0, n_dev + MAX_GAP["cd"] + 1, n_ref)
            return [(w_r[i], h_r[i]) for i in range(n_check)], n_ref
        at, stops = [], []
        for i in range(n_check):
            if family == "mu":
                snaps, n_ref = ref.fit_mu(xs[i], w0[i], h0[i], **kw)
            else:
                snaps, n_ref = ref.fit_beta(
                    xs[i], w0[i], h0[i], 1.0 if family == "kl" else 0.0, **kw
                )
            at.append(snaps[min(int(n_dev[i]), max(snaps))][:2])
            stops.append(n_ref)
        return at, np.asarray(stops)

    rows = []
    for family, kernel in (("mu", "mu_pallas.fit_mu_pallas"),
                           ("cd", "cd_pallas.fit_cd_pallas"),
                           ("kl", "beta_pallas (beta=1)"),
                           ("is", "beta_pallas (beta=0)")):
        xs = x_pos if family == "is" else x
        wk, hk, nk = (np.asarray(a) for a in fit(family, "pallas", xs))
        wx, hx, nx = (np.asarray(a) for a in fit(family, "xla", xs))
        at_k, n_ref = ref_at(family, xs, nk[:n_check])
        at_x, _ = ref_at(family, xs, nx[:n_check])
        err_k = max(ref.factor_error(wk[i], hk[i], *at_k[i])
                    for i in range(n_check))
        err_x = max(ref.factor_error(wx[i], hx[i], *at_x[i])
                    for i in range(n_check))
        gap = int(np.max(np.abs(nk[:n_check] - n_ref)))
        gap_x = int(np.max(np.abs(nx[:n_check] - n_ref)))
        t_k = _median_seconds(lambda: fit(family, "pallas", xs), sz.repeats)
        t_x = _median_seconds(lambda: fit(family, "xla", xs), sz.repeats)
        line = (f"kernel {kernel} on {jax.devices()[0].device_kind}: "
                f"{sz.batch[0]}x{sz.batch[1]}x{sz.batch[2]}"
                f" rank {sz.rank}, fit {t_k * 1e3:.3f} ms vs XLA "
                f"{t_x * 1e3:.3f} ms ({t_x / t_k:.2f}x); vs float64 "
                f"kernel {err_k:.2e} XLA {err_x:.2e} (tol "
                f"{TOLERANCES[family][0]:g}), stopping gap kernel {gap} "
                f"XLA {gap_x} (max {MAX_GAP[family]})")
        print(line)
        _within(f"{family} kernel", family, err_k)
        _check(gap <= MAX_GAP[family], f"{family} kernel: gap {gap}")
        rows.append((family, t_k, t_x))
    return rows


# ---------------------------------------------------------------- phase 7
def phase_serve(sz: Sizes, emgs, fs) -> None:
    import jax

    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.models import CNMFModel, NM3FModel, NMFModel
    from muscle_synergies_tpu.models import export
    from muscle_synergies_tpu.utils.config import PipelineConfig

    xs = np.asarray(preprocess_trials(emgs, fs, PipelineConfig()))
    platforms = ("cuda", "cpu")
    # jax.export serializes through the flatbuffers package, which a
    # machine may lack; the lowered program itself runs without it
    serializes = importlib.util.find_spec("flatbuffers") is not None
    _, t, l = xs.shape
    nmf = NMFModel(sz.rank, max_iter=500, tol=1e-5).fit(xs[0])
    cnmf = CNMFModel(3, sz.lags, max_iter=200, n_inits=2).fit(xs[0])
    nm3f = NM3FModel(3, 2, max_iter=200, n_inits=2).fit(xs)

    def served(model, shape):
        if serializes:
            fn = export.load_transform(export.export_transform(
                model, shape, dtype=xs.dtype, platforms=platforms
            ))
            program = fn.exported
        else:  # the artifact's program, run without its bytes
            program = export._lower(model, shape, xs.dtype, platforms)

            def fn(x):
                return np.asarray(program.call(jax.numpy.asarray(x)))
        _check(tuple(program.platforms) == platforms,
               f"artifact platforms {program.platforms}")
        return fn

    parts = []
    for name, model, shape, batch in (
        ("NMFModel", nmf, (t, l), xs[1]),
        ("CNMFModel", cnmf, (t, l), xs[1]),
        ("NM3FModel", nm3f, xs.shape, xs),
    ):
        got = served(model, shape)(batch)
        want = np.asarray(model.transform(batch))
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        parts.append(_within(name, "serve", err))
    sym = served(nmf, ("b", t, l))
    for b in (3, 5):
        batch = np.resize(xs, (b,) + xs.shape[1:])
        got = sym(batch)
        want = np.stack([np.asarray(nmf.transform(batch[i]))
                         for i in range(b)])
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        parts.append(_within(f"symbolic batch {b}", "serve", err))
    print(f"serve ({jax.default_backend()}, programs for "
          f"{'+'.join(platforms)}, "
          f"{'serialized' if serializes else 'in memory: no flatbuffers'}"
          "): " + "; ".join(parts))


# ------------------------------------------------------------ four cards
def phase_mesh(sz: Sizes, emgs, fs) -> None:
    """The sharded dataset path and solvers against one card's results."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from muscle_synergies_tpu.dataset import analyze_dataset, preprocess_trials
    from muscle_synergies_tpu.models.batch import fit_cd_batch, fit_mu_batch
    from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch, init_cnmf
    from muscle_synergies_tpu.parallel import (
        make_mesh,
        sharded_fit_cd,
        sharded_fit_cnmf,
        sharded_fit_mu,
    )
    from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS
    from muscle_synergies_tpu.utils.config import PipelineConfig

    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    # the CLI's analyze-dataset defaults: ranks 1..4, max_iter 10k
    ranks = sz.ranks[:4]
    cfg = PipelineConfig(max_iter=min(sz.max_iter, 10_000), tol=sz.tol)
    t0 = time.perf_counter()
    meshed = analyze_dataset(emgs, fs, ranks=ranks, config=cfg, mesh=mesh)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    local = analyze_dataset(emgs, fs, ranks=ranks, config=cfg)
    t_local = time.perf_counter() - t0
    v_err = float(np.max(np.abs(meshed.vaf_overall - local.vaf_overall)))
    parts = [_within("dataset VAF", "vaf", v_err)
             + f" ({t_mesh:.2f} s meshed, {t_local:.2f} s one card)"]

    xs = preprocess_trials(emgs, fs, PipelineConfig())
    b = xs.shape[0] - xs.shape[0] % 2
    xs = xs[:b]
    rng = np.random.default_rng(0)
    avg = float(np.sqrt(np.asarray(xs).mean() / sz.rank))
    w0 = jnp.asarray(avg * rng.random((b, xs.shape[1], sz.rank)), xs.dtype)
    h0 = jnp.asarray(avg * rng.random((b, sz.rank, xs.shape[2])), xs.dtype)
    kw = dict(max_iter=200, tol=1e-4)
    x_s = jax.device_put(xs, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS)))
    w_s = jax.device_put(w0, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS)))
    h_s = jax.device_put(h0, NamedSharding(mesh, P(DATA_AXIS)))

    def rel(a, b_):
        a, b_ = np.asarray(a), np.asarray(b_)
        return float(np.max(np.abs(a - b_)) / np.max(np.abs(b_)))

    st, ref_st = (sharded_fit_mu(x_s, w_s, h_s, mesh, **kw),
                  fit_mu_batch(xs, w0, h0, impl="xla", **kw))
    parts.append(_within("sharded_fit_mu", "shard",
                         max(rel(st.w, ref_st.w), rel(st.h, ref_st.h))))
    st, ref_st = (sharded_fit_cd(x_s, w_s, h_s, mesh, **kw),
                  fit_cd_batch(xs, w0, h0, impl="xla", **kw))
    parts.append(_within("sharded_fit_cd", "shard",
                         max(rel(st.w, ref_st.w), rel(st.ht, ref_st.ht))))
    c0, s0 = init_cnmf(np.asarray(xs), 3, sz.lags, seed=0)
    c0, s0 = jnp.asarray(c0), jnp.asarray(s0)
    st = sharded_fit_cnmf(
        x_s, jax.device_put(c0, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS))),
        jax.device_put(s0, NamedSharding(mesh, P(DATA_AXIS))), mesh, **kw,
    )
    ref_st = fit_cnmf_batch(xs, c0, s0, **kw)
    parts.append(_within("sharded_fit_cnmf", "shard",
                         max(rel(st.c, ref_st.c), rel(st.s, ref_st.s))))
    print("mesh 2x2 (data, time) vs one card: " + "; ".join(parts))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    import jax

    from muscle_synergies_tpu.utils.platform import enable_compile_cache

    phase_device(args.chips)
    enable_compile_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        paths, emgs, fs = phase_ingest(FULL, workdir, args.seed)
        if args.chips == 4:
            phase_mesh(FULL, emgs, fs)
        else:
            phase_preprocess(emgs, fs)
            phase_solve(FULL, paths, workdir)
            phase_families(FULL, paths, emgs, fs, workdir)
            phase_kernels(FULL, args.seed)
            phase_serve(FULL, emgs, fs)
    dev = jax.devices()[0]
    count = 4 if args.chips == 4 else len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
