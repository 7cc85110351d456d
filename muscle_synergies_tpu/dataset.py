"""Whole-dataset synergy analysis: many trials, many ranks, one solve.

The reference factorizes one matrix at a time in a Python loop
(reference analysis.py:909-913).  Here the full ``(rank, trial)`` grid
becomes a single batched device computation:

1. every trial is preprocessed through a
   :class:`~muscle_synergies_tpu.utils.PipelineConfig` (time
   normalization lands all trials on a common length);
2. factors for every rank are zero-padded to the maximum rank — padded
   components stay exactly zero under the MU updates, so each grid
   entry is equivalent to an independent fit;
3. one vmapped (or mesh-sharded) solver call fits all ``R x B``
   problems with per-problem convergence.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from ._optional import is_pandas, pandas

from .models.batch import fit_cd_batch, fit_mu_batch, vaf_batch
from .utils.config import PipelineConfig
from .utils.platform import resolve_impl

__all__ = [
    "DatasetResult",
    "SpaceByTimeDatasetResult",
    "TimeVaryingDatasetResult",
    "analyze_dataset",
    "analyze_dataset_pipelined",
    "analyze_dataset_space_by_time",
    "analyze_dataset_time_varying",
    "preprocess_trials",
]


def _channel_names(first) -> Optional[List[str]]:
    """Column labels of the first trial, when it carries any."""
    if is_pandas(first):
        return list(first.columns)
    if hasattr(first, "coords"):  # DeviceData
        return list(first.coords)
    return None


def _normalize_trials_subjects(trials, subjects):
    """Flatten a ``{subject: trials}`` mapping / validate ``subjects=``."""
    if isinstance(trials, Mapping):
        if subjects is not None:
            raise ValueError(
                "pass either a {subject: trials} mapping or subjects=, not both"
            )
        subjects = [s for s, ts in trials.items() for _ in ts]
        trials = [t for ts in trials.values() for t in ts]
    if subjects is not None:
        subjects = list(subjects)
        if len(subjects) != len(trials):
            raise ValueError(
                f"got {len(subjects)} subject labels for {len(trials)} trials"
            )
    return trials, subjects


def _match_components(reference: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Reorder ``other``'s rows to best match ``reference``'s by cosine.

    Greedy assignment on the pairwise cosine-similarity matrix — the
    standard way to align synergy sets across trials before averaging
    (NMF is permutation-invariant, so row order is arbitrary per fit).
    """
    eps = 1e-12
    ref = reference / (np.linalg.norm(reference, axis=1, keepdims=True) + eps)
    oth = other / (np.linalg.norm(other, axis=1, keepdims=True) + eps)
    sim = ref @ oth.T  # (k, k)
    k = sim.shape[0]
    order = np.empty(k, dtype=int)
    sim = sim.copy()
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(sim), sim.shape)
        order[i] = j
        sim[i, :] = -np.inf
        sim[:, j] = -np.inf
    return other[order]


def _as_array(trial) -> np.ndarray:
    if is_pandas(trial):
        return trial.to_numpy(dtype=float)
    if hasattr(trial, "array"):  # DeviceData
        return np.asarray(trial.array, dtype=float)
    return np.asarray(trial, dtype=float)


def _fold_channels(xs: jnp.ndarray) -> jnp.ndarray:
    """``(B, N, L) -> (N, B*L)``: trials become extra channels.

    The time-axis kernels (moving RMS, SOS filtering) treat channels
    independently, so a whole batch runs as ONE sharded ``(N, C)``
    problem instead of a vmap over trials.
    """
    b, n, l = xs.shape
    return jnp.transpose(xs, (1, 0, 2)).reshape(n, b * l)


def _unfold_channels(y: jnp.ndarray, b: int, l: int) -> jnp.ndarray:
    n = y.shape[0]
    return jnp.transpose(y.reshape(n, b, l), (1, 0, 2))


def _sharded_rms_batch(xs, window, mask, mesh):
    """``moving_rms_batch`` twin with the sample axis mesh-sharded.

    Padded trials are exact: the reference's ``'same'`` convolution
    zero-pads beyond each trial's true end, which is precisely what
    the stacked batch's zero padding provides; outputs in the padding
    region are re-zeroed by the mask.
    """
    from .parallel.filters import sharded_moving_rms

    b, n, l = xs.shape
    if mask is not None:
        lengths = np.asarray(jnp.sum(mask, axis=1))
        if (lengths < window).any():
            shortest = int(lengths.min())
            raise ValueError(
                f"window ({window} samples) is longer than the shortest "
                f"trial ({shortest} valid samples)"
            )
    out = _unfold_channels(
        sharded_moving_rms(_fold_channels(xs), window, mesh), b, l
    )
    if mask is not None:
        out = out * mask[..., None]
    return out


def _sharded_envelope_batch(xs, spec, sampling_frequency, zero_center_, mesh):
    """``linear_envelope_batch`` twin with the lowpass mesh-sharded.

    Zero-centering and rectification are cheap element-wise stages and
    stay local; the zero-phase SOS cascade — the expensive time-axis
    recurrence — runs through the exact sequence-parallel filter
    (:func:`muscle_synergies_tpu.parallel.filters.sharded_sosfiltfilt`,
    same ``padtype='odd'`` default as the local ``digital_filter``).
    """
    from .parallel.filters import sharded_sosfilt, sharded_sosfiltfilt

    b, n, l = xs.shape
    if zero_center_:
        xs = xs - jnp.mean(xs, axis=1, keepdims=True)
    folded = _fold_channels(jnp.abs(xs))
    sos = spec.design(sampling_frequency)
    if spec.zero_lag:
        y = sharded_sosfiltfilt(sos, folded, mesh)
    else:
        y = sharded_sosfilt(sos, folded, mesh)
    return _unfold_channels(y, b, l)


def _usable_mesh(mesh, caller: str):
    """Return ``mesh`` when it carries the ``(data, time)`` axes.

    Every meshed path in this module shards over those two names; a
    mesh built with other axis names (e.g. the tensor-parallel
    ``(data, model)`` layout) would crash deep inside a
    ``PartitionSpec`` — warn and fall back to the local path instead.
    """
    if mesh is None:
        return None
    from .parallel.mesh import DATA_AXIS, TIME_AXIS

    missing = {DATA_AXIS, TIME_AXIS} - set(mesh.axis_names)
    if missing:
        import warnings

        warnings.warn(
            f"{caller}: mesh {mesh.axis_names} lacks the "
            f"{sorted(missing)} axis (a (data, time) mesh is "
            "required); falling back to the local single-device path.",
            stacklevel=3,
        )
        return None
    return mesh


def preprocess_trials(
    trials: Sequence,
    sampling_frequency: float,
    config: PipelineConfig = PipelineConfig(),
    dtype=None,
    mesh=None,
) -> jnp.ndarray:
    """Run the configured preprocessing on every trial and stack them.

    ``config.reduce_to`` must be set (it is what makes ragged trials
    stack into one ``(B, reduce_to, L)`` batch).

    The masked batched transforms preprocess the whole batch in a
    handful of fused device computations
    (:mod:`muscle_synergies_tpu.ops.batched`) instead of one dispatch
    chain per trial.  The RMS pipeline is exact under zero padding, so
    ragged batches run as one padded batch; the filtered envelope's
    zero-phase edge reflection must touch each trial's true last
    sample, so ragged envelope batches run as one vmapped computation
    per *distinct trial length* — identical results to per-trial
    processing either way (pinned by tests).

    Args:
        mesh: optional ``(data, time)`` mesh.  When its ``time`` axis
            has more than one device, the expensive time-axis stage —
            the moving RMS or the envelope's zero-phase lowpass — runs
            through the exact sequence-parallel kernels
            (:mod:`muscle_synergies_tpu.parallel.filters`), with the
            trial batch folded onto the channel axis so the whole
            batch is one sharded ``(N, B*L)`` problem.  Results are
            identical to the local path up to float reordering
            (pinned by tests).
    """
    if config.reduce_to is None:
        raise ValueError(
            "preprocess_trials needs config.reduce_to so trials share a "
            "common length"
        )
    # a (B, N, L) array IS an equal-length batch: keep it on device
    # (the pipelined loader stages chunks there ahead of time — no
    # per-trial host round-trip)
    is_batch = getattr(trials, "ndim", None) == 3
    if is_batch:
        arrays = None
        ragged = False
    else:
        arrays = [_as_array(t) for t in trials]
        ragged = len({a.shape[0] for a in arrays}) > 1

    from .io.batch import stack_trials
    from .ops import batched as _b

    time_shards = 1
    if mesh is not None:
        from .parallel.mesh import TIME_AXIS

        time_shards = dict(mesh.shape).get(TIME_AXIS, 1)

    def envelope_batch(xs):
        # The envelope filter runs in float64 whatever the working
        # dtype: composing a 4 Hz / 2 kHz lowpass's near-unit poles over
        # a 124k-sample capture through the associative scan loses
        # about 25% relative accuracy in float32 (vs scipy's float64
        # sosfiltfilt).  The result returns in the working dtype.
        spec = config.envelope
        out_dtype = jnp.result_type(float)
        with jax.enable_x64(True):
            xs = jnp.asarray(xs, jnp.float64)
            if time_shards > 1:
                ys = _sharded_envelope_batch(
                    xs, spec, sampling_frequency, config.zero_center, mesh
                )
            else:
                ys = _b.linear_envelope_batch(
                    xs,
                    critical_freqs=(
                        spec.critical_freqs[0]
                        if len(spec.critical_freqs) == 1
                        else list(spec.critical_freqs)
                    ),
                    sampling_frequency=sampling_frequency,
                    order=spec.order,
                    filter_type=spec.filter_type,
                    zero_lag=spec.zero_lag,
                    cheby_param=spec.cheby_param,
                    zero_center_=config.zero_center,
                )
        return ys.astype(out_dtype)

    def finish(xs, mask=None):
        # after resampling onto reduce_to points every row is valid
        xs = _b.time_normalize_batch(xs, config.reduce_to, mask)
        if config.amplitude_normalize:
            xs = _b.normalize_batch(jnp.abs(xs))
        return xs

    if config.use_rms:
        if is_batch:
            xs = jnp.asarray(trials)
            mask = None
        else:
            stacked = stack_trials(arrays)
            xs = stacked.data
            mask = stacked.mask if ragged else None
        if config.zero_center:
            xs = _b.zero_center_batch(xs, mask)
        window = int(round(config.rms_window_s * sampling_frequency))
        if time_shards > 1:
            xs = _sharded_rms_batch(xs, window, mask, mesh)
        else:
            xs = _b.moving_rms_batch(xs, window, mask)
        batch = finish(xs, mask)
    elif not ragged:
        batch = finish(envelope_batch(trials if is_batch else np.stack(arrays)))
    else:
        # one fused computation per distinct trial length
        by_length: dict = {}
        for idx, a in enumerate(arrays):
            by_length.setdefault(a.shape[0], []).append(idx)
        slots = [None] * len(arrays)
        for indices in by_length.values():
            group = finish(envelope_batch(np.stack([arrays[i] for i in indices])))
            for j, i in enumerate(indices):
                slots[i] = group[j]
        batch = jnp.stack(slots)
    if dtype is not None:
        batch = batch.astype(dtype)
    return batch


@dataclass
class DatasetResult:
    """Synergies for every ``(rank, trial)`` pair of a dataset.

    Attributes:
        ranks: the swept ranks.
        w: ``(R, B, N, k_max)`` transformed signals (rank-padded).
        h: ``(R, B, k_max, L)`` components (rank-padded).
        vaf_overall: ``(R, B)`` total VAF.
        vaf_per_channel: ``(R, B, L)``.
        n_iter: ``(R, B)`` solver iterations.
        converged: ``(R, B)`` convergence flags.
        channel_names: channel labels when the inputs carried them.
        subjects: per-trial subject labels (grouped reporting), or
            ``None`` for a flat trial list.
        sampling_frequency: EMG rate of the analyzed captures, when the
            loader discovered it (:func:`analyze_dataset_pipelined`).
    """

    ranks: tuple
    w: np.ndarray
    h: np.ndarray
    vaf_overall: np.ndarray
    vaf_per_channel: np.ndarray
    n_iter: np.ndarray
    converged: np.ndarray
    channel_names: Optional[List[str]] = None
    subjects: Optional[List] = None
    sampling_frequency: Optional[float] = None

    def components(self, rank: int, trial: int) -> pandas.DataFrame:
        """``(rank, L)`` components of one fit, labeled."""
        r = self.ranks.index(rank)
        h = self.h[r, trial][:rank]
        cols = self.channel_names or range(h.shape[1])
        return pandas.DataFrame(h, columns=list(cols))

    def vaf_table(self) -> pandas.DataFrame:
        """Trials x ranks table of overall VAF.

        With subject labels the index is a ``(subject, trial)``
        MultiIndex; otherwise a flat trial index.
        """
        b = self.vaf_overall.shape[1]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.DataFrame(
            self.vaf_overall.T, columns=list(self.ranks), index=index
        )

    # -- subject-level reporting -------------------------------------------
    def _require_subjects(self):
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: trials} "
                "mapping) to analyze_dataset"
            )

    def trials_of(self, subject) -> List[int]:
        """Trial indices belonging to one subject."""
        self._require_subjects()
        return [i for i, s in enumerate(self.subjects) if s == subject]

    def subject_table(self, statistic: str = "mean") -> pandas.DataFrame:
        """Subjects x ranks table of overall VAF, aggregated over trials.

        ``statistic`` is any pandas groupby reduction name (``"mean"``,
        ``"std"``, ``"min"``, ``"median"``, ...).
        """
        self._require_subjects()
        table = self.vaf_table()
        return table.groupby(level="subject", sort=False).agg(statistic)

    def subject_min_rank(self, vaf_threshold: float = 0.9) -> pandas.Series:
        """Per subject: smallest swept rank whose *mean* VAF over the
        subject's trials reaches the threshold (-1 if none does)."""
        self._require_subjects()
        means = self.subject_table("mean")
        out = {}
        for subject, row in means.iterrows():
            reaching = [k for k in sorted(self.ranks) if row[k] >= vaf_threshold]
            out[subject] = reaching[0] if reaching else -1
        return pandas.Series(out, name="min_rank")

    def subject_components(self, rank: int, subject) -> pandas.DataFrame:
        """Mean synergy components of one subject at one rank.

        Each trial's ``(rank, L)`` factor rows are aligned to the
        subject's first trial by greedy cosine matching (NMF row order
        is arbitrary per fit) before averaging.
        """
        self._require_subjects()
        trials = self.trials_of(subject)
        if not trials:
            raise KeyError(f"unknown subject: {subject!r}")
        r = self.ranks.index(rank)
        reference = self.h[r, trials[0]][:rank]
        stacked = [reference]
        for t in trials[1:]:
            stacked.append(_match_components(reference, self.h[r, t][:rank]))
        mean = np.mean(stacked, axis=0)
        cols = self.channel_names or range(mean.shape[1])
        return pandas.DataFrame(mean, columns=list(cols))

    def cluster_subjects(self, rank: int, n_clusters: Optional[int] = None):
        """Group-level synergy clusters across subjects at one rank.

        Feeds each subject's trial-averaged components
        (:meth:`subject_components`) to
        :func:`~muscle_synergies_tpu.models.cluster_synergies` — the
        Cheung-style shared-vs-specific analysis: ``.shared`` lists the
        clusters every subject expresses, ``.coverage`` how widely each
        is shared, ``.consensus`` the group-level synergy of each
        cluster.  Input sets follow the subject order of first
        appearance in ``self.subjects`` (``dict.fromkeys`` order), so
        ``result.labels[j]`` belongs to the ``j``-th distinct subject.

        Requires at least two subjects (clustering one set is just the
        set itself).
        """
        from .models.stability import cluster_synergies

        self._require_subjects()
        ordered = list(dict.fromkeys(self.subjects))
        sets = [
            self.subject_components(rank, s).to_numpy() for s in ordered
        ]
        return cluster_synergies(sets, n_clusters=n_clusters)

    def min_rank_reaching(self, vaf_threshold: float = 0.9) -> np.ndarray:
        """Per trial: smallest swept rank whose VAF >= threshold (-1 if none)."""
        reached = self.vaf_overall >= vaf_threshold  # (R, B)
        out = np.full(reached.shape[1], -1, dtype=int)
        # visit ranks smallest-first so the answer is the minimum rank
        # even when the sweep order is not ascending
        for i in sorted(range(len(self.ranks)), key=lambda j: self.ranks[j]):
            newly = reached[i] & (out == -1)
            out[newly] = self.ranks[i]
        return out


def analyze_dataset(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    ranks: Union[int, Sequence[int]] = (1, 2, 3, 4),
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    init: Optional[str] = None,
    solver: Optional[str] = None,
    beta_loss=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    dtype=None,
    seed: int = 0,
    subjects: Optional[Sequence] = None,
    impl: Optional[str] = None,
    inner_iter: Optional[int] = None,
    alpha_W: float = 0.0,
    alpha_H="same",
    l1_ratio: float = 0.0,
) -> DatasetResult:
    """Preprocess and factorize a whole multi-trial dataset at once.

    Args:
        trials: sequence of ``(N_i, L)`` arrays / DataFrames /
            ``DeviceData`` (e.g. the EMG of several captures), or a
            ``{subject: [trials...]}`` mapping — the subject x trial
            hierarchy flattens into one batched solve and the labels
            power :class:`DatasetResult`'s grouped reporting.
        ranks: rank or ranks to sweep.
        subjects: per-trial subject labels (alternative to passing a
            mapping; must be omitted when ``trials`` is one).
        impl: batched-solver implementation — ``"xla"``, ``"pallas"``
            (the fused Triton kernels, GPU only, every solver and beta)
            or ``"auto"`` (the kernel on a GPU, xla elsewhere; see
            :func:`muscle_synergies_tpu.utils.platform.resolve_impl`);
            defaults to ``config.solver_impl``.  Ignored when a
            ``mesh`` routes the solve through the sharded solvers.
        inner_iter: accelerated-MU inner repetitions; defaults to
            ``config.inner_iter`` (1 = sklearn-exact).
        alpha_W / alpha_H / l1_ratio: sklearn's dimension-scaled
            sparsity penalties (``alpha_H="same"`` mirrors
            ``alpha_W``), honored identically on the batched AND the
            mesh-sharded solve paths; zero-rank-padded grid entries
            stay exactly zero under penalties (their update numerators
            are identically zero).  Nonzero penalties require the XLA
            batched impl (``impl='pallas'`` raises).
        config: preprocessing + solver preset.
        mesh: optional ``(data, time)`` mesh — the solve runs through
            the sharded solvers when the grid divides evenly over the
            data axis, and the preprocessing's expensive time-axis
            stage (the moving RMS or the envelope's zero-phase
            lowpass) runs through the exact sequence-parallel kernels
            whenever the ``time`` axis has more than one device
            (see :func:`preprocess_trials`).
        solver: ``"mu"`` or ``"cd"``; defaults to ``config.solver``
            (the :class:`PipelineConfig` default is ``"cd"``, matching
            the reference's sklearn default).
        beta_loss: ``"frobenius"`` (default via ``config.beta_loss``),
            ``"kullback-leibler"``, ``"itakura-saito"`` or a float
            beta; non-Frobenius losses require ``solver="mu"``.  With a
            dividing ``mesh``, every loss routes through the sharded
            solvers (``sharded_fit_mu``/``sharded_fit_cd``/
            ``sharded_fit_beta``; ``impl`` is ignored there, as for
            every meshed solve).
        dtype: computation dtype (e.g. ``jnp.float32``).

    Returns:
        :class:`DatasetResult` over the full ``(rank, trial)`` grid.
    """
    trials, subjects = _normalize_trials_subjects(trials, subjects)
    mesh = _usable_mesh(mesh, "analyze_dataset")
    if isinstance(ranks, int):
        ranks = (ranks,)
    ranks = tuple(ranks)
    solver = solver if solver is not None else config.solver
    if solver not in {"mu", "cd"}:
        raise ValueError(f"unknown solver: {solver!r}")
    from .models.beta import beta_loss_to_float

    if beta_loss is None:
        beta_loss = getattr(config, "beta_loss", "frobenius")
    beta = beta_loss_to_float(beta_loss)
    if beta != 2.0 and solver != "mu":
        raise ValueError(
            f"beta_loss={beta_loss!r} requires solver='mu', got {solver!r}"
        )
    if beta != 2.0 and (
        inner_iter if inner_iter is not None else getattr(config, "inner_iter", 1)
    ) != 1:
        # the Gram-reuse acceleration only exists for the Frobenius
        # objective — fail loudly instead of silently running plain MU
        raise ValueError(
            "inner_iter > 1 is only available for the Frobenius objective"
        )
    max_iter = max_iter if max_iter is not None else config.max_iter
    tol = tol if tol is not None else config.tol
    alpha_h_val = alpha_W if alpha_H == "same" else float(alpha_H)
    has_penalty = alpha_W != 0.0 or alpha_h_val != 0.0
    impl = resolve_impl(
        impl if impl is not None else getattr(config, "solver_impl", "xla"),
        "mu" if beta == 2.0 and solver == "mu" else (
            "cd" if beta == 2.0 else "beta"
        ),
        rank=max(ranks),
        penalized=has_penalty,
    )
    inner_iter = (
        inner_iter if inner_iter is not None else getattr(config, "inner_iter", 1)
    )
    if inner_iter != 1 and solver != "mu":
        raise ValueError("inner_iter > 1 is only meaningful for solver='mu'")

    channel_names = _channel_names(trials[0])

    xs = preprocess_trials(
        trials, sampling_frequency, config, dtype=dtype, mesh=mesh
    )
    if beta <= 0 and bool(jnp.any(xs == 0)):
        raise ValueError(
            "When beta_loss <= 0 and X contains zeros, the solver may "
            "diverge. Please add small values to X, or use a positive "
            "beta_loss."
        )
    b = xs.shape[0]
    k_max = max(ranks)
    # sklearn's dimension-scaled penalties, from the GLOBAL (N, L)
    from .models.select import compute_regularization

    l1_w, l2_w, l1_h, l2_h = compute_regularization(
        alpha_W, alpha_H, l1_ratio, xs.shape[1], xs.shape[2]
    )

    # (R * B) problem grid with rank-padded factors; one vmapped init
    # batch per rank (a single device dispatch each) instead of R*B
    # host-side SVD round-trips
    from .models.batch import init_batch

    w_blocks, h_blocks = [], []
    for k in ranks:
        w0, h0 = init_batch(xs, k, init=init, seed=seed)
        pad_w = jnp.zeros((b, xs.shape[1], k_max - k), xs.dtype)
        pad_h = jnp.zeros((b, k_max - k, xs.shape[2]), xs.dtype)
        w_blocks.append(jnp.concatenate([w0.astype(xs.dtype), pad_w], axis=2))
        h_blocks.append(jnp.concatenate([h0.astype(xs.dtype), pad_h], axis=1))
    grid_x = jnp.tile(xs, (len(ranks), 1, 1))
    grid_w = jnp.concatenate(w_blocks, axis=0)
    grid_h = jnp.concatenate(h_blocks, axis=0)

    # The data axis is exact under padding (every fit is independent):
    # an indivisible (ranks x trials) grid gains duplicate fits that are
    # dropped from the result.  The time axis cannot be padded without
    # changing the factorization (padded samples would enter the
    # Grams), so indivisible sample counts still fall back.
    n_fits = grid_x.shape[0]
    pad_fits = (-n_fits) % mesh.shape["data"] if mesh is not None else 0
    mesh_divides = (
        mesh is not None
        and grid_x.shape[1] % mesh.shape.get("time", 1) == 0
    )
    if mesh is not None and not mesh_divides:
        import warnings

        warnings.warn(
            f"analyze_dataset: trial length {grid_x.shape[1]} does not "
            f"divide over the mesh's "
            f"{mesh.shape.get('time', 1)}-way time axis; falling back "
            "to the local single-device solver. Adjust reduce_to or "
            "the mesh shape to keep the fit sharded.",
            stacklevel=2,
        )
    if mesh_divides:
        from .parallel import (
            sharded_fit_beta,
            sharded_fit_cd,
            sharded_fit_mu,
        )
        from .parallel.mesh import DATA_AXIS, TIME_AXIS
        from jax.sharding import NamedSharding, PartitionSpec as P

        if pad_fits:
            grid_x = jnp.concatenate(
                [grid_x, jnp.repeat(grid_x[:1], pad_fits, axis=0)], axis=0
            )
            grid_w = jnp.concatenate(
                [grid_w, jnp.repeat(grid_w[:1], pad_fits, axis=0)], axis=0
            )
            grid_h = jnp.concatenate(
                [grid_h, jnp.repeat(grid_h[:1], pad_fits, axis=0)], axis=0
            )
        grid_x = jax.device_put(
            grid_x, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        grid_w = jax.device_put(
            grid_w, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        grid_h = jax.device_put(
            grid_h, NamedSharding(mesh, P(DATA_AXIS, None, None))
        )
        regs = dict(
            l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h, l2_reg_h=l2_h
        )
        if beta != 2.0:
            state = sharded_fit_beta(
                grid_x, grid_w, grid_h, mesh, beta=beta,
                max_iter=max_iter, tol=tol, **regs,
            )
        elif solver == "mu":
            state = sharded_fit_mu(
                grid_x, grid_w, grid_h, mesh, max_iter=max_iter, tol=tol,
                inner_iter=inner_iter, **regs,
            )
        else:
            state = sharded_fit_cd(
                grid_x, grid_w, grid_h, mesh, max_iter=max_iter, tol=tol,
                **regs,
            )
        if pad_fits:
            state = jax.tree.map(lambda a: a[:n_fits], state)
            grid_x = grid_x[:n_fits]
    elif beta != 2.0:
        from .models.batch import fit_mu_beta_batch

        state = fit_mu_beta_batch(
            grid_x, grid_w, grid_h, beta=beta, max_iter=max_iter, tol=tol,
            impl=impl, l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h,
            l2_reg_h=l2_h,
        )
    elif solver == "mu":
        state = fit_mu_batch(
            grid_x, grid_w, grid_h, max_iter=max_iter, tol=tol,
            impl=impl, inner_iter=inner_iter, l1_reg_w=l1_w, l2_reg_w=l2_w,
            l1_reg_h=l1_h, l2_reg_h=l2_h,
        )
    else:
        state = fit_cd_batch(
            grid_x, grid_w, grid_h, max_iter=max_iter, tol=tol, impl=impl,
            l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h, l2_reg_h=l2_h,
        )

    h_final = state.h if solver == "mu" else jnp.swapaxes(state.ht, -1, -2)
    overall, per_channel = vaf_batch(grid_x, state.w, h_final)
    r, = (len(ranks),)
    return DatasetResult(
        ranks=ranks,
        w=np.asarray(state.w).reshape(r, b, *state.w.shape[1:]),
        h=np.asarray(h_final).reshape(r, b, *h_final.shape[1:]),
        vaf_overall=np.asarray(overall).reshape(r, b),
        vaf_per_channel=np.asarray(per_channel).reshape(r, b, -1),
        n_iter=np.asarray(state.n_iter).reshape(r, b),
        converged=np.asarray(state.converged).reshape(r, b),
        channel_names=channel_names,
        subjects=subjects,
    )


def _default_capture_loader(path):
    """Parse one Vicon capture and return its EMG ``DeviceData``."""
    from .io.vicon import load_vicon_file

    return load_vicon_file(path).emg


def _concat_dataset_results(
    partials: Sequence[DatasetResult],
    channel_names=None,
    subjects=None,
    sampling_frequency=None,
) -> DatasetResult:
    """Stitch per-chunk grid results back into one dataset result."""
    cat = lambda name: np.concatenate(  # noqa: E731 - local glue
        [getattr(p, name) for p in partials], axis=1
    )
    return DatasetResult(
        ranks=partials[0].ranks,
        w=cat("w"),
        h=cat("h"),
        vaf_overall=cat("vaf_overall"),
        vaf_per_channel=cat("vaf_per_channel"),
        n_iter=cat("n_iter"),
        converged=cat("converged"),
        channel_names=channel_names,
        subjects=list(subjects) if subjects is not None else None,
        sampling_frequency=sampling_frequency,
    )


def analyze_dataset_pipelined(
    paths: Sequence,
    sampling_frequency: Optional[float] = None,
    ranks: Union[int, Sequence[int]] = (1, 2, 3, 4),
    config: PipelineConfig = PipelineConfig(),
    chunk_files: int = 2,
    prefetch: int = 2,
    loader=None,
    subjects: Optional[Sequence] = None,
    dtype=None,
    **fit_kwargs,
) -> DatasetResult:
    """:func:`analyze_dataset` over capture *files*, parse/compute
    overlapped.

    The reference analyzes many captures strictly sequentially — parse,
    preprocess, factorize, next file (reference analysis.py:909-913).
    Here the files stream through a two-stage pipeline (the
    pipeline-parallelism analog of SURVEY §2.5): a producer thread
    parses ``chunk_files`` captures at a time and stages each chunk on
    device (:func:`muscle_synergies_tpu.io.batch.device_prefetch`
    issues the async H2D up to ``prefetch`` chunks ahead), while the
    consumer runs the batched preprocess + ``(rank, trial)`` grid solve
    on the chunk already resident.  Host CSV decoding therefore
    overlaps device compute and transfer instead of serializing with
    them.

    Chunked solves match the one-shot :func:`analyze_dataset` to
    float-reordering tolerance (a chunk's batch dimension changes XLA's
    batched-GEMM blocking — same caveat as
    :mod:`muscle_synergies_tpu.models.resume`); inits are per-trial
    deterministic, so the grids are otherwise identical.  A chunk whose
    captures have unequal lengths falls back to the per-length grouped
    preprocess automatically (the envelope's edge reflection must see
    every trial's true last sample).

    Args:
        paths: capture CSV paths (or any values ``loader`` accepts).
        sampling_frequency: EMG rate; when ``None`` it is taken from
            the first capture and every file is checked against it.
        chunk_files: captures per pipeline stage — one batched
            preprocess + grid solve each.  Larger chunks give the solver
            bigger batches; smaller chunks overlap more.
        prefetch: chunks the producer may stage ahead (the pipeline
            depth); ``device_prefetch``'s buffer size.
        loader: ``path -> DataFrame | DeviceData | array`` parse hook;
            defaults to loading the capture's EMG device.
        fit_kwargs: forwarded to :func:`analyze_dataset` (``solver``,
            ``beta_loss``, ``impl``, ``max_iter``, ``tol``, ...).

    Returns:
        :class:`DatasetResult` over the full grid, with
        ``sampling_frequency`` filled in from the captures.
    """
    from .io.batch import device_prefetch

    paths = list(paths)
    if not paths:
        raise ValueError("analyze_dataset_pipelined needs at least one path")
    if chunk_files < 1:
        raise ValueError(f"chunk_files must be >= 1, got {chunk_files}")
    if subjects is not None:
        subjects = list(subjects)
        if len(subjects) != len(paths):
            raise ValueError(
                f"got {len(subjects)} subject labels for {len(paths)} paths"
            )
    loader = loader if loader is not None else _default_capture_loader

    # filled by the producer before its first yield; the prefetch
    # queue's put/get ordering makes them visible to the consumer
    first_meta: dict = {}

    def parsed_chunks():
        fs = sampling_frequency
        for lo in range(0, len(paths), chunk_files):
            group = paths[lo : lo + chunk_files]
            arrays = []
            for path in group:
                cap = loader(path)
                cap_fs = getattr(cap, "sampling_frequency", None)
                if fs is None:
                    fs = cap_fs
                elif cap_fs is not None and cap_fs != fs:
                    raise ValueError(
                        f"{path}: EMG sampling rate {cap_fs} != {fs} "
                        f"of the first capture"
                    )
                if not first_meta:
                    if fs is None:
                        raise ValueError(
                            "pass sampling_frequency=: the loader's "
                            "output does not carry one"
                        )
                    first_meta.update(
                        names=_channel_names(cap), fs=float(fs)
                    )
                arrays.append(_as_array(cap))
            if len({a.shape[0] for a in arrays}) == 1:
                yield np.stack(arrays)  # staged on device as ONE batch
            else:
                yield arrays  # ragged: preprocess groups by length

    partials = []
    for chunk in device_prefetch(parsed_chunks(), buffer_size=prefetch):
        partials.append(
            analyze_dataset(
                chunk,
                first_meta["fs"],
                ranks=ranks,
                config=config,
                dtype=dtype,
                **fit_kwargs,
            )
        )
    return _concat_dataset_results(
        partials,
        channel_names=first_meta["names"],
        subjects=subjects,
        sampling_frequency=first_meta["fs"],
    )


@dataclass
class TimeVaryingDatasetResult:
    """Best-restart time-varying synergies for every trial of a dataset.

    Attributes:
        n_lags: temporal extent ``D`` of each synergy, in samples.
        c: ``(B, T, K)`` winning activation trains (rescaled by
            :func:`~muscle_synergies_tpu.models.cnmf.normalize_synergies`).
        s: ``(B, K, D, L)`` winning synergies, unit Frobenius norm.
        vaf_overall: ``(B,)`` total VAF of each reconstruction.
        vaf_per_channel: ``(B, L)``.
        n_iter: ``(B,)`` iterations used by each winning restart.
        converged: ``(B,)`` convergence flags of the winners.
        restart_errors: ``(B, n_inits)`` final Frobenius errors of all
            restarts (the winner is each row's argmin).
        channel_names / subjects: as on :class:`DatasetResult`.
    """

    n_lags: int
    c: np.ndarray
    s: np.ndarray
    vaf_overall: np.ndarray
    vaf_per_channel: np.ndarray
    n_iter: np.ndarray
    converged: np.ndarray
    restart_errors: np.ndarray
    channel_names: Optional[List[str]] = None
    subjects: Optional[List] = None

    def synergies(self, trial: int) -> Mapping[int, pandas.DataFrame]:
        """``{k: (n_lags, L) DataFrame}`` patterns of one trial."""
        cols = self.channel_names or range(self.s.shape[-1])
        return {
            k: pandas.DataFrame(self.s[trial, k], columns=list(cols))
            for k in range(self.s.shape[1])
        }

    def activations(self, trial: int) -> pandas.DataFrame:
        """``(T, K)`` recruitment trains of one trial."""
        k = self.c.shape[-1]
        return pandas.DataFrame(
            self.c[trial], columns=[f"synergy {i}" for i in range(k)]
        )

    def vaf_table(self) -> pandas.Series:
        """Per-trial overall VAF (subject/trial MultiIndex when labeled)."""
        b = self.vaf_overall.shape[0]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.Series(self.vaf_overall, index=index, name="vaf")

    def subject_table(self, statistic: str = "mean") -> pandas.Series:
        """Per-subject VAF aggregated over trials."""
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: trials} "
                "mapping) to analyze_dataset_time_varying"
            )
        return self.vaf_table().groupby(level="subject", sort=False).agg(
            statistic
        )

    def to_trial_result(self, trial: int):
        """One trial repackaged as a
        :class:`~muscle_synergies_tpu.models.cnmf.TimeVaryingSynergyResult`
        (what :func:`~muscle_synergies_tpu.viz.plot_time_varying_synergies`
        consumes)."""
        from .models.cnmf import TimeVaryingSynergyResult

        cols = list(self.channel_names or range(self.s.shape[-1]))
        return TimeVaryingSynergyResult(
            synergies=self.synergies(trial),
            activations=self.activations(trial),
            vaf=float(self.vaf_overall[trial]),
            vaf_per_muscle=pandas.Series(
                self.vaf_per_channel[trial], index=cols
            ),
            n_iter=int(self.n_iter[trial]),
            restart_errors=self.restart_errors[trial],
        )


def analyze_dataset_time_varying(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    n_synergies: int,
    n_lags: int,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    n_inits: int = 4,
    seed: int = 0,
    dtype=None,
    subjects: Optional[Sequence] = None,
    impl: Optional[str] = None,
    precision=None,
) -> TimeVaryingDatasetResult:
    """Preprocess a dataset and extract time-varying synergies per trial.

    The convolutive companion to :func:`analyze_dataset` (the reference
    loops time-invariant sklearn fits only, reference
    analysis.py:909-913): all ``B`` trials' ``n_inits`` random restarts
    join ONE ``(B * n_inits)``-problem batched fit — a single device
    computation, or a mesh-sharded one with lag-halo exchanges over the
    time axis — and each trial's lowest-error restart is returned with
    unit-norm synergies.

    Args:
        trials / sampling_frequency / config / dtype / subjects: as on
            :func:`analyze_dataset` (the preprocessing pipeline is
            shared, including the meshed sequence-parallel filters).
        n_synergies: number of time-varying synergies ``K`` per trial.
        n_lags: temporal extent ``D`` of each synergy, in samples (of
            the time-normalized trials, i.e. relative to
            ``config.reduce_to``).
        max_iter / tol: sklearn-style stopping; default to the config's.
        n_inits: random restarts per trial, batched into the same solve.
        seed: base seed; the flat problem index offsets it.
        mesh: optional ``(data, time)`` mesh — the fit runs through
            :func:`~muscle_synergies_tpu.parallel.sharded_fit_cnmf`
            when the time axis divides the trial length and one time
            shard covers the ``n_lags - 1`` halo (warns + falls back
            locally otherwise; the restart grid pads the data axis
            exactly like :func:`analyze_dataset`).
        impl: ``"auto"`` or ``"xla"``; defaults to
            ``config.solver_impl``.  The convolutive model has no
            hand-written kernel, so both run the batched XLA fit
            (``"pallas"`` raises).
        precision: matmul precision for the contractions (e.g.
            ``"highest"`` — see models/cnmf.py docstrings).

    Returns:
        :class:`TimeVaryingDatasetResult` over all trials.
    """
    from .models.cnmf import (
        cnmf_reconstruct,
        fit_cnmf_batch,
        init_cnmf,
        normalize_synergies,
    )
    from .models.mu import EPSILON

    trials, subjects = _normalize_trials_subjects(trials, subjects)
    mesh = _usable_mesh(mesh, "analyze_dataset_time_varying")
    if n_synergies < 1:
        raise ValueError(f"n_synergies must be >= 1, got {n_synergies}")
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")
    max_iter = max_iter if max_iter is not None else config.max_iter
    tol = tol if tol is not None else config.tol

    channel_names = _channel_names(trials[0])

    xs = preprocess_trials(
        trials, sampling_frequency, config, dtype=dtype, mesh=mesh
    )
    b, t, l = xs.shape
    if not 1 <= n_lags <= t:
        raise ValueError(
            f"n_lags must be in [1, n_samples={t}], got {n_lags}"
        )

    resolve_impl(
        impl if impl is not None else getattr(config, "solver_impl", "xla"),
        "cnmf",
    )

    # Restart grid: trial-major, restarts contiguous; per-problem seeds
    # come from init_cnmf's batched seed + flat-index rule.  The grid
    # replication happens on device (jnp.repeat) AND on host
    # (np.repeat of the once-downloaded xs, which the VAF section needs
    # anyway) so the big grid never crosses the host<->device link.
    xs_np = np.asarray(xs)
    grid_x = jnp.repeat(xs, n_inits, axis=0)
    c0, s0 = init_cnmf(
        np.repeat(xs_np, n_inits, axis=0), n_synergies, n_lags, seed=seed
    )
    n_fits = b * n_inits

    pad_fits = (-n_fits) % mesh.shape["data"] if mesh is not None else 0
    mesh_divides = (
        mesh is not None
        and t % mesh.shape.get("time", 1) == 0
        and n_lags - 1 <= t // mesh.shape.get("time", 1)
    )
    if mesh is not None and not mesh_divides:
        import warnings

        warnings.warn(
            f"analyze_dataset_time_varying: trial length {t} must divide "
            f"over the mesh's {mesh.shape.get('time', 1)}-way time axis "
            f"with one shard covering the lag halo ({n_lags - 1}); "
            "falling back to the local single-device solver.",
            stacklevel=2,
        )
    if mesh_divides:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel import sharded_fit_cnmf
        from .parallel.mesh import DATA_AXIS, TIME_AXIS

        grid_c, grid_s = jnp.asarray(c0), jnp.asarray(s0)
        if pad_fits:
            grid_x = jnp.concatenate(
                [grid_x, jnp.repeat(grid_x[:1], pad_fits, axis=0)], axis=0
            )
            grid_c = jnp.concatenate(
                [grid_c, jnp.repeat(grid_c[:1], pad_fits, axis=0)], axis=0
            )
            grid_s = jnp.concatenate(
                [grid_s, jnp.repeat(grid_s[:1], pad_fits, axis=0)], axis=0
            )
        grid_x = jax.device_put(
            grid_x, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        grid_c = jax.device_put(
            grid_c, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        grid_s = jax.device_put(
            grid_s, NamedSharding(mesh, P(DATA_AXIS, None, None, None))
        )
        state = sharded_fit_cnmf(
            grid_x, grid_c, grid_s, mesh, max_iter=max_iter, tol=tol,
            precision=precision,
        )
        if pad_fits:
            state = jax.tree.map(lambda a: a[:n_fits], state)
    else:
        state = fit_cnmf_batch(
            grid_x, jnp.asarray(c0), jnp.asarray(s0),
            max_iter=max_iter, tol=tol, precision=precision,
        )

    errors = np.asarray(state.previous_error).reshape(b, n_inits)
    best = np.arange(b) * n_inits + np.argmin(errors, axis=1)
    # winner gather stays on device: only the (B, ...) winners ever
    # cross the link, not the full (B * n_inits) restart grid
    best_dev = jnp.asarray(best)
    c_best = jnp.take(state.c, best_dev, axis=0)
    s_best = jnp.take(state.s, best_dev, axis=0)
    c_best, s_best = normalize_synergies(c_best, s_best)

    xs_local = jnp.asarray(xs_np)  # gathered off any mesh above
    rec = jax.vmap(
        functools.partial(cnmf_reconstruct, precision=precision)
    )(c_best, s_best)
    err2 = jnp.sum((xs_local - rec) ** 2, axis=1)  # (B, L)
    tot2 = jnp.sum(xs_local * xs_local, axis=1)
    per_channel = 1.0 - err2 / jnp.where(tot2 == 0, 1.0, tot2)
    overall = 1.0 - jnp.sum(err2, axis=-1) / jnp.maximum(
        jnp.sum(tot2, axis=-1), EPSILON
    )

    return TimeVaryingDatasetResult(
        n_lags=n_lags,
        c=np.asarray(c_best),
        s=np.asarray(s_best),
        vaf_overall=np.asarray(overall),
        vaf_per_channel=np.asarray(per_channel),
        n_iter=np.asarray(state.n_iter)[best],
        converged=np.asarray(state.converged)[best],
        restart_errors=errors,
        channel_names=channel_names,
        subjects=subjects,
    )


@dataclass
class SpaceByTimeDatasetResult:
    """Shared space-by-time modules for a whole dataset (NM3F).

    Unlike the per-trial results above, the modules themselves ARE the
    dataset-level quantity — every trial is described by one small
    coefficient matrix against the SHARED temporal/spatial modules
    (Delis et al. 2014; see :mod:`muscle_synergies_tpu.models.nm3f`).

    Attributes:
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the muscles when the trials carry labels.
        coefficients: ``(B, P, Q)`` per-trial mixing coefficients.
        vaf_overall: overall VAF across the dataset (scalar float).
        vaf_per_trial: ``(B,)``.
        vaf_per_channel: ``(B, L)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
        channel_names / subjects: as on :class:`DatasetResult`.
    """

    n_temporal: int
    n_spatial: int
    temporal_modules: pandas.DataFrame
    spatial_modules: pandas.DataFrame
    coefficients: np.ndarray
    vaf_overall: float
    vaf_per_trial: np.ndarray
    vaf_per_channel: np.ndarray
    n_iter: int
    restart_errors: np.ndarray
    channel_names: Optional[List[str]] = None
    subjects: Optional[List] = None

    def vaf_table(self) -> pandas.Series:
        """Per-trial VAF (subject/trial MultiIndex when labeled)."""
        b = self.vaf_per_trial.shape[0]
        if self.subjects is not None:
            index = pandas.MultiIndex.from_arrays(
                [self.subjects, range(b)], names=["subject", "trial"]
            )
        else:
            index = pandas.RangeIndex(b, name="trial")
        return pandas.Series(self.vaf_per_trial, index=index, name="vaf")

    def subject_table(self, statistic: str = "mean") -> pandas.Series:
        """Per-subject VAF aggregated over trials."""
        if self.subjects is None:
            raise ValueError(
                "no subject labels: pass subjects= (or a {subject: "
                "trials} mapping) to analyze_dataset_space_by_time"
            )
        return self.vaf_table().groupby(level="subject", sort=False).agg(
            statistic
        )

    def to_result(self):
        """Repackage as a
        :class:`~muscle_synergies_tpu.models.nm3f.SpaceByTimeResult`
        (what :func:`~muscle_synergies_tpu.viz.plot_space_by_time`
        consumes)."""
        from .models.nm3f import SpaceByTimeResult

        return SpaceByTimeResult(
            temporal_modules=self.temporal_modules,
            spatial_modules=self.spatial_modules,
            coefficients=self.coefficients,
            vaf=self.vaf_overall,
            vaf_per_trial=self.vaf_per_trial,
            n_iter=self.n_iter,
            restart_errors=self.restart_errors,
        )


def analyze_dataset_space_by_time(
    trials: Union[Sequence, Mapping],
    sampling_frequency: float,
    n_temporal: int,
    n_spatial: int,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    max_iter: Optional[int] = None,
    tol: Optional[float] = None,
    n_inits: int = 4,
    seed: int = 0,
    dtype=None,
    subjects: Optional[Sequence] = None,
    precision=None,
) -> SpaceByTimeDatasetResult:
    """Preprocess a dataset and extract its space-by-time synergies.

    The trilinear companion to :func:`analyze_dataset` (spatial-only)
    and :func:`analyze_dataset_time_varying` (convolutive): one NM3F
    fit over the whole trial stack yields SHARED temporal and spatial
    modules plus one small coefficient matrix per trial — the
    single-trial-decoding representation of Delis et al. (2014).  The
    reference has no dataset-level surface at all (it loops sklearn
    fits per trial, reference analysis.py:909-913).

    Args:
        trials / sampling_frequency / config / dtype / subjects: as on
            :func:`analyze_dataset` (the preprocessing pipeline is
            shared, including the meshed sequence-parallel filters).
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        max_iter / tol: sklearn-style stopping; default to the config's.
        n_inits: random restarts (each a full dataset fit; batched into
            one vmapped computation locally, sequential sharded fits on
            a mesh).
        mesh: optional ``(data, time)`` mesh — preprocessing runs
            through the sequence-parallel filters and every restart
            through
            :func:`~muscle_synergies_tpu.parallel.sharded_fit_nm3f`
            (trial counts zero-pad exactly over ``data``; a
            non-dividing time axis warns and solves locally).
        precision: matmul precision for every NM3F contraction (e.g.
            ``"highest"`` — see models/nm3f.py's module docstring for
            the precision policy).

    Returns:
        :class:`SpaceByTimeDatasetResult` for the whole dataset.
    """
    from .models.nm3f import find_space_by_time_synergies

    trials, subjects = _normalize_trials_subjects(trials, subjects)
    mesh = _usable_mesh(mesh, "analyze_dataset_space_by_time")
    max_iter = max_iter if max_iter is not None else config.max_iter
    tol = tol if tol is not None else config.tol
    channel_names = _channel_names(trials[0])

    xs = preprocess_trials(
        trials, sampling_frequency, config, dtype=dtype, mesh=mesh
    )
    xs_np = np.asarray(xs)
    res = find_space_by_time_synergies(
        xs_np, n_temporal, n_spatial, max_iter=max_iter, tol=tol,
        n_inits=n_inits, seed=seed, mesh=mesh, precision=precision,
    )

    spatial = res.spatial_modules
    if channel_names is not None:
        spatial = spatial.set_axis(list(channel_names), axis=1)

    # per-channel VAF of the winning reconstruction
    w = res.temporal_modules.to_numpy()
    s = spatial.to_numpy()
    rec = np.einsum("tp,bpq,ql->btl", w, res.coefficients, s)
    err2 = np.sum((xs_np - rec) ** 2, axis=1)  # (B, L)
    tot2 = np.sum(xs_np * xs_np, axis=1)
    per_channel = 1.0 - err2 / np.where(tot2 == 0, 1.0, tot2)

    return SpaceByTimeDatasetResult(
        n_temporal=n_temporal,
        n_spatial=n_spatial,
        temporal_modules=res.temporal_modules,
        spatial_modules=spatial,
        coefficients=res.coefficients,
        vaf_overall=res.vaf,
        vaf_per_trial=res.vaf_per_trial,
        vaf_per_channel=per_channel,
        n_iter=res.n_iter,
        restart_errors=res.restart_errors,
        channel_names=channel_names,
        subjects=subjects,
    )
