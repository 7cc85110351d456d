"""Tests for whole-dataset analysis over the (rank, trial) grid."""

import numpy as np
import pandas as pd
import pytest

from muscle_synergies_tpu import analyze_dataset
from muscle_synergies_tpu.dataset import preprocess_trials
from muscle_synergies_tpu.parallel import make_mesh
from muscle_synergies_tpu.utils import PipelineConfig

RNG = np.random.default_rng(17)


def _trials(b=4, l=6, k=2):
    out = []
    for i in range(b):
        n = 500 + 40 * i  # ragged lengths
        w = np.abs(RNG.standard_normal((n, k)))
        h = RNG.random((k, l))
        out.append(
            pd.DataFrame(
                np.maximum(w @ h + 0.02 * RNG.random((n, l)), 0),
                columns=[f"M{j}" for j in range(l)],
            )
        )
    return out


CFG = PipelineConfig(use_rms=True, rms_window_s=0.05, reduce_to=100)


class TestPreprocess:
    def test_ragged_trials_stack(self):
        xs = preprocess_trials(_trials(), 200, CFG)
        assert xs.shape == (4, 100, 6)
        assert np.all(np.asarray(xs) >= 0)

    def test_requires_reduce_to(self):
        with pytest.raises(ValueError, match="reduce_to"):
            preprocess_trials(
                _trials(), 200, PipelineConfig(reduce_to=None)
            )

    def test_batched_rms_path_matches_per_trial(self):
        # the fused masked pipeline must equal running config.preprocess
        # on each ragged trial separately
        trials = _trials()
        batched = np.asarray(preprocess_trials(trials, 200, CFG))
        per_trial = np.stack(
            [np.asarray(CFG.preprocess(t.to_numpy(), 200)) for t in trials]
        )
        np.testing.assert_allclose(batched, per_trial, rtol=1e-12, atol=1e-12)

    def test_batched_envelope_path_matches_per_trial(self):
        cfg = PipelineConfig(reduce_to=100)  # filtered envelope
        trials = [t.iloc[:500] for t in _trials()]  # equal lengths
        batched = np.asarray(preprocess_trials(trials, 200, cfg))
        per_trial = np.stack(
            [np.asarray(cfg.preprocess(t.to_numpy(), 200)) for t in trials]
        )
        np.testing.assert_allclose(batched, per_trial, rtol=1e-10, atol=1e-12)

    def test_ragged_envelope_matches_per_trial(self):
        # ragged envelope batches group by length; each group must be
        # exactly the per-trial result
        cfg = PipelineConfig(reduce_to=100)
        trials = _trials()  # 4 distinct lengths
        trials.append(trials[1].copy() * 1.3)  # a repeated length
        batched = np.asarray(preprocess_trials(trials, 200, cfg))
        per_trial = np.stack(
            [np.asarray(cfg.preprocess(t.to_numpy(), 200)) for t in trials]
        )
        assert batched.shape == (5, 100, 6)
        np.testing.assert_allclose(batched, per_trial, rtol=1e-10, atol=1e-12)


class TestAnalyzeDataset:
    @pytest.fixture(scope="class")
    def result(self):
        return analyze_dataset(
            _trials(),
            200,
            ranks=(1, 2, 3),
            config=CFG,
            max_iter=500,
            tol=1e-7,
        )

    def test_grid_shapes(self, result):
        assert result.vaf_overall.shape == (3, 4)
        assert result.vaf_per_channel.shape == (3, 4, 6)
        assert result.h.shape == (3, 4, 3, 6)
        assert result.n_iter.shape == (3, 4)

    def test_rank_padding_is_exact(self, result):
        # rank-1 fits must have zero components beyond the first
        np.testing.assert_array_equal(result.h[0][:, 1:, :], 0)

    def test_vaf_reasonable(self, result):
        # data has true rank 2: rank-2 VAF should be high for all trials
        assert np.all(result.vaf_overall[1] > 0.98)

    def test_components_accessor(self, result):
        comps = result.components(rank=2, trial=0)
        assert comps.shape == (2, 6)
        assert list(comps.columns) == [f"M{j}" for j in range(6)]

    def test_vaf_table_and_threshold(self, result):
        table = result.vaf_table()
        assert table.shape == (4, 3)
        min_ranks = result.min_rank_reaching(0.95)
        assert min_ranks.shape == (4,)
        assert np.all(min_ranks <= 2)
        assert np.all(min_ranks >= 1)

    def test_single_rank_int(self):
        res = analyze_dataset(
            _trials(b=2), 200, ranks=2, config=CFG, max_iter=300, tol=1e-6
        )
        assert res.vaf_overall.shape == (1, 2)

    def test_sharded_matches_local(self):
        trials = _trials(b=4)
        # MU's chunked error check is robust to the float reordering a
        # mesh introduces; CD's per-iteration violation threshold can
        # flip a borderline trial's stopping iteration, so iteration
        # equality is only asserted for MU.
        kwargs = dict(ranks=(1, 2), config=CFG, solver="mu",
                      max_iter=300, tol=1e-6)
        local = analyze_dataset(trials, 200, **kwargs)
        mesh = make_mesh((4, 2))
        sharded = analyze_dataset(trials, 200, mesh=mesh, **kwargs)
        np.testing.assert_allclose(
            sharded.vaf_overall, local.vaf_overall, rtol=1e-6
        )
        np.testing.assert_array_equal(sharded.n_iter, local.n_iter)


class TestAnalyzeDatasetTimeVarying:
    @pytest.fixture(scope="class")
    def trials(self):
        # one draw shared by every test: _trials() advances the module
        # RNG, so separate calls would give different data
        return _trials()

    @pytest.fixture(scope="class")
    def result(self, trials):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        return analyze_dataset_time_varying(
            trials, 200, n_synergies=2, n_lags=10, config=CFG,
            max_iter=200, tol=1e-5, n_inits=3, seed=0,
        )

    def test_shapes(self, result):
        assert result.c.shape == (4, 100, 2)
        assert result.s.shape == (4, 2, 10, 6)
        assert result.vaf_overall.shape == (4,)
        assert result.vaf_per_channel.shape == (4, 6)
        assert result.restart_errors.shape == (4, 3)
        assert result.n_iter.shape == (4,)
        assert result.channel_names == [f"M{j}" for j in range(6)]

    def test_vaf_reasonable(self, result):
        assert np.all(result.vaf_overall > 0.5)
        assert np.all(result.vaf_overall <= 1.0)

    def test_unit_norm_synergies(self, result):
        norms = np.linalg.norm(result.s.reshape(4, 2, -1), axis=2)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-10)

    def test_accessors(self, result):
        syn = result.synergies(1)
        assert set(syn) == {0, 1}
        assert syn[0].shape == (10, 6)
        assert list(syn[0].columns) == result.channel_names
        act = result.activations(2)
        assert act.shape == (100, 2)
        table = result.vaf_table()
        np.testing.assert_allclose(table.to_numpy(), result.vaf_overall)

    def test_to_trial_result_plots(self, result):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from muscle_synergies_tpu.viz import plot_time_varying_synergies

        tv = result.to_trial_result(0)
        assert tv.vaf == pytest.approx(result.vaf_overall[0])
        assert tv.n_iter == int(result.n_iter[0])
        assert list(tv.vaf_per_muscle.index) == result.channel_names
        fig = plot_time_varying_synergies(tv, show=False)
        assert len(fig.axes) == 4  # 2 synergies x (pattern, activation)
        plt.close(fig)

    def test_trial0_matches_single_trial_entry_point(self, trials, result):
        """Trial 0's restart seeds coincide with the single-trial API's
        (both are seed + restart index), so the winner must agree."""
        from muscle_synergies_tpu import find_time_varying_synergies

        xs = preprocess_trials(trials, 200, CFG)
        df = pd.DataFrame(
            np.asarray(xs[0]), columns=[f"M{j}" for j in range(6)]
        )
        single = find_time_varying_synergies(
            df, 2, 10, max_iter=200, tol=1e-5, n_inits=3, seed=0
        )
        assert int(result.n_iter[0]) == single.n_iter
        np.testing.assert_allclose(
            result.vaf_overall[0], single.vaf, rtol=1e-9
        )
        np.testing.assert_allclose(
            result.restart_errors[0], single.restart_errors, rtol=1e-9
        )

    def test_sharded_matches_local(self, trials, result):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        mesh = make_mesh((4, 2))
        sharded = analyze_dataset_time_varying(
            trials, 200, n_synergies=2, n_lags=10, config=CFG,
            max_iter=200, tol=1e-5, n_inits=3, seed=0, mesh=mesh,
        )
        np.testing.assert_array_equal(sharded.n_iter, result.n_iter)
        np.testing.assert_allclose(
            sharded.vaf_overall, result.vaf_overall, rtol=1e-8
        )
        np.testing.assert_allclose(sharded.c, result.c, rtol=1e-6,
                                   atol=1e-10)
        np.testing.assert_allclose(sharded.s, result.s, rtol=1e-6,
                                   atol=1e-10)

    def test_mesh_halo_fallback_warns(self, trials, result):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        mesh = make_mesh((2, 4))  # 25-sample time shards < 29 halo
        with pytest.warns(UserWarning, match="lag halo"):
            fallback = analyze_dataset_time_varying(
                trials, 200, n_synergies=2, n_lags=30, config=CFG,
                max_iter=50, tol=1e-5, n_inits=2, seed=0, mesh=mesh,
            )
        assert fallback.vaf_overall.shape == (4,)

    def test_subject_mapping(self):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        trials = _trials()
        res = analyze_dataset_time_varying(
            {"s1": trials[:2], "s2": trials[2:]}, 200,
            n_synergies=2, n_lags=6, config=CFG, max_iter=60, n_inits=2,
        )
        table = res.vaf_table()
        assert table.index.names == ["subject", "trial"]
        agg = res.subject_table("mean")
        assert list(agg.index) == ["s1", "s2"]

    def test_validation(self):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        trials = _trials(b=2)
        with pytest.raises(ValueError, match="n_synergies"):
            analyze_dataset_time_varying(
                trials, 200, n_synergies=0, n_lags=4, config=CFG
            )
        with pytest.raises(ValueError, match="n_inits"):
            analyze_dataset_time_varying(
                trials, 200, n_synergies=2, n_lags=4, config=CFG,
                n_inits=0,
            )
        with pytest.raises(ValueError, match="n_lags"):
            analyze_dataset_time_varying(
                trials, 200, n_synergies=2, n_lags=101, config=CFG
            )


class TestSubjectHierarchy:
    @pytest.fixture(scope="class")
    def result(self):
        trials = _trials(b=6)
        return analyze_dataset(
            {"s1": trials[:2], "s2": trials[2:5], "s3": trials[5:]},
            200,
            ranks=(1, 2),
            config=CFG,
            max_iter=300,
            tol=1e-7,
        )

    def test_mapping_flattens_in_order(self, result):
        assert result.subjects == ["s1", "s1", "s2", "s2", "s2", "s3"]
        assert result.trials_of("s2") == [2, 3, 4]

    def test_vaf_table_multiindex(self, result):
        table = result.vaf_table()
        assert table.index.names == ["subject", "trial"]
        assert table.loc[("s2", 3), 2] == result.vaf_overall[1, 3]

    def test_subject_table_aggregates(self, result):
        means = result.subject_table("mean")
        assert list(means.index) == ["s1", "s2", "s3"]
        expected = result.vaf_overall[:, 2:5].mean(axis=1)
        np.testing.assert_allclose(means.loc["s2"].to_numpy(), expected)

    def test_subject_min_rank(self, result):
        min_ranks = result.subject_min_rank(0.9)
        # rank-2 ground truth: every subject reaches 90% VAF by rank 2
        assert set(min_ranks.index) == {"s1", "s2", "s3"}
        assert (min_ranks <= 2).all() and (min_ranks >= 1).all()

    def test_subject_components_matched_mean(self, result):
        comps = result.subject_components(2, "s2")
        assert comps.shape == (2, 6)
        assert list(comps.columns) == [f"M{j}" for j in range(6)]
        assert (comps.to_numpy() >= 0).all()
        with pytest.raises(KeyError):
            result.subject_components(2, "nobody")

    def test_cluster_subjects_structure(self, result):
        clusters = result.cluster_subjects(2)
        assert clusters.n_clusters == 2  # default: mean set size
        assert [len(l) for l in clusters.labels] == [2, 2, 2]
        assert clusters.consensus.shape == (2, 6)
        assert clusters.membership.shape == (2, 3)
        assert clusters.membership.sum() == 6
        np.testing.assert_allclose(
            np.linalg.norm(clusters.consensus, axis=1), 1.0, rtol=1e-12
        )

    def test_explicit_subjects_argument(self):
        trials = _trials(b=4)
        res = analyze_dataset(
            trials, 200, ranks=2, config=CFG, max_iter=50,
            subjects=["a", "a", "b", "b"],
        )
        assert res.trials_of("b") == [2, 3]

    def test_validation(self):
        trials = _trials(b=4)
        with pytest.raises(ValueError, match="subject labels"):
            analyze_dataset(
                trials, 200, ranks=2, config=CFG, max_iter=10,
                subjects=["a"],
            )
        with pytest.raises(ValueError, match="not both"):
            analyze_dataset(
                {"a": trials}, 200, ranks=2, config=CFG, max_iter=10,
                subjects=["a"] * 4,
            )
        flat = analyze_dataset(trials, 200, ranks=2, config=CFG, max_iter=10)
        with pytest.raises(ValueError, match="no subject labels"):
            flat.subject_table()


def test_component_matching_aligns_permutations():
    from muscle_synergies_tpu.dataset import _match_components

    ref = np.eye(3) + 0.01
    shuffled = ref[[2, 0, 1]] * 1.7  # permuted + rescaled
    matched = _match_components(ref, shuffled)
    np.testing.assert_allclose(matched, ref * 1.7)


def test_min_rank_reaching_unordered_sweep():
    from muscle_synergies_tpu.dataset import DatasetResult

    res = DatasetResult(
        ranks=(4, 3, 2), w=None, h=None,
        vaf_overall=np.array([[0.95], [0.95], [0.95]]),
        vaf_per_channel=None, n_iter=None, converged=None,
    )
    assert res.min_rank_reaching(0.9).tolist() == [2]


def test_cluster_subjects_recovers_shared_synergies():
    from muscle_synergies_tpu.dataset import DatasetResult

    rng = np.random.default_rng(7)
    base = np.eye(2, 6) + 0.05 * rng.random((2, 6))
    # 4 trials, 2 subjects, every trial a permuted/rescaled copy of the
    # same two synergies
    h = np.stack([
        base * 1.0,
        base[::-1] * 2.0,
        base * 0.7,
        base[::-1] * 1.3,
    ])[None]  # (R=1, B=4, k_max=2, L=6)
    res = DatasetResult(
        ranks=(2,), w=None, h=h,
        vaf_overall=np.full((1, 4), 0.95), vaf_per_channel=None,
        n_iter=None, converged=None,
        channel_names=[f"M{j}" for j in range(6)],
        subjects=["a", "a", "b", "b"],
    )
    clusters = res.cluster_subjects(2)
    assert clusters.n_clusters == 2
    np.testing.assert_array_equal(clusters.membership, 1)
    assert list(clusters.shared) == [0, 1]
    unit = base / np.linalg.norm(base, axis=1, keepdims=True)
    best = (unit @ clusters.consensus.T).max(axis=1)
    assert (best > 0.999).all()
    # requires subject labels
    flat = DatasetResult(
        ranks=(2,), w=None, h=h,
        vaf_overall=np.full((1, 4), 0.95), vaf_per_channel=None,
        n_iter=None, converged=None,
    )
    with pytest.raises(ValueError, match="subject labels"):
        flat.cluster_subjects(2)


def test_analyze_dataset_inner_iter():
    trials = _trials(b=4)
    base = analyze_dataset(
        trials, 200, ranks=2, config=CFG, solver="mu", max_iter=60
    )
    fast = analyze_dataset(
        trials, 200, ranks=2, config=CFG, solver="mu", max_iter=60,
        inner_iter=3,
    )
    # accelerated MU reaches at least the plain-MU VAF in the same
    # outer-iteration budget
    assert np.all(fast.vaf_overall >= base.vaf_overall - 1e-9)
    with pytest.raises(ValueError, match="inner_iter"):
        analyze_dataset(
            trials, 200, ranks=2, config=CFG, solver="cd", inner_iter=2
        )
    # solver='cd' + impl='pallas' routes the fused CD kernel, which
    # needs a GPU: without one it raises instead of interpreting
    with pytest.raises(RuntimeError, match="GPU"):
        analyze_dataset(
            trials, 200, ranks=2, config=CFG, solver="cd", impl="pallas",
            max_iter=100,
        )
    res = analyze_dataset(
        trials, 200, ranks=2, config=CFG, solver="cd", impl="auto",
        max_iter=100,
    )
    assert res.vaf_overall.shape == (1, 4)


def test_analyze_dataset_cd_solver():
    trials = _trials(b=2)
    res = analyze_dataset(
        trials, 200, ranks=(1, 2), config=CFG, solver="cd",
        max_iter=300, tol=1e-7,
    )
    assert res.vaf_overall.shape == (2, 2)
    assert np.all(res.vaf_overall[1] > 0.98)
    # rank padding stays exact under CD too
    np.testing.assert_array_equal(res.h[0][:, 1:, :], 0)


def test_sharded_pads_indivisible_fit_grid():
    """A (ranks x trials) grid that does not divide the data axis now
    shards via duplicate-fit padding instead of falling back, and the
    results match the local solver exactly."""
    import warnings

    trials = _trials(b=3)  # 3 fits on a 4-way data axis
    kwargs = dict(ranks=(2,), config=CFG, solver="mu", max_iter=200,
                  tol=1e-6)
    local = analyze_dataset(trials, 200, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the old path warned + fell back
        sharded = analyze_dataset(
            trials, 200, mesh=make_mesh((4, 2)), **kwargs
        )
    np.testing.assert_allclose(
        sharded.vaf_overall, local.vaf_overall, rtol=1e-6
    )
    np.testing.assert_array_equal(sharded.n_iter, local.n_iter)
    assert sharded.vaf_overall.shape == (1, 3)


def test_impl_auto_resolves_by_backend():
    """impl='auto' picks xla off the GPU and still produces correct fits."""
    trials = _trials(b=2)
    res = analyze_dataset(
        trials, 200, ranks=2, config=CFG, impl="auto", max_iter=200,
        tol=1e-6,
    )
    assert res.vaf_overall.shape == (1, 2)
    assert np.all(res.vaf_overall > 0.9)


class TestAnalyzeDatasetSpaceByTime:
    @pytest.fixture(scope="class")
    def trials(self):
        return _trials()

    @pytest.fixture(scope="class")
    def result(self, trials):
        from muscle_synergies_tpu import analyze_dataset_space_by_time

        return analyze_dataset_space_by_time(
            trials, 200, n_temporal=3, n_spatial=2, config=CFG,
            max_iter=300, tol=1e-6, n_inits=3, seed=0,
        )

    def test_shapes_and_labels(self, result):
        assert result.temporal_modules.shape == (100, 3)
        assert result.spatial_modules.shape == (2, 6)
        assert list(result.spatial_modules.columns) == [
            f"M{j}" for j in range(6)
        ]
        assert result.coefficients.shape == (4, 3, 2)
        assert result.vaf_per_trial.shape == (4,)
        assert result.vaf_per_channel.shape == (4, 6)
        assert result.restart_errors.shape == (3,)
        assert result.channel_names == [f"M{j}" for j in range(6)]

    def test_unit_norm_modules_and_vaf(self, result):
        np.testing.assert_allclose(
            np.linalg.norm(result.temporal_modules.to_numpy(), axis=0),
            1.0, rtol=1e-10,
        )
        np.testing.assert_allclose(
            np.linalg.norm(result.spatial_modules.to_numpy(), axis=1),
            1.0, rtol=1e-10,
        )
        assert 0.5 < result.vaf_overall <= 1.0
        assert np.all(result.vaf_per_trial > 0.5)

    def test_matches_model_entry_point(self, trials, result):
        """Same preprocessing + seeds = the models-layer result."""
        from muscle_synergies_tpu import find_space_by_time_synergies

        xs = np.asarray(preprocess_trials(trials, 200, CFG))
        direct = find_space_by_time_synergies(
            xs, 3, 2, max_iter=300, tol=1e-6, n_inits=3, seed=0
        )
        np.testing.assert_allclose(
            result.temporal_modules.to_numpy(),
            direct.temporal_modules.to_numpy(),
        )
        np.testing.assert_allclose(
            result.coefficients, direct.coefficients
        )
        assert result.n_iter == direct.n_iter

    def test_meshed_matches_local(self, trials, result):
        from muscle_synergies_tpu import analyze_dataset_space_by_time

        meshed = analyze_dataset_space_by_time(
            trials, 200, n_temporal=3, n_spatial=2, config=CFG,
            max_iter=300, tol=1e-6, n_inits=3, seed=0,
            mesh=make_mesh((2, 4)),
        )
        assert meshed.n_iter == result.n_iter
        np.testing.assert_allclose(
            meshed.temporal_modules.to_numpy(),
            result.temporal_modules.to_numpy(), rtol=1e-6, atol=1e-10,
        )
        np.testing.assert_allclose(
            meshed.coefficients, result.coefficients,
            rtol=1e-6, atol=1e-10,
        )

    def test_subject_tables_and_to_result(self, trials, result):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from muscle_synergies_tpu import analyze_dataset_space_by_time
        from muscle_synergies_tpu.viz import plot_space_by_time

        labeled = analyze_dataset_space_by_time(
            {"s1": trials[:2], "s2": trials[2:]}, 200,
            n_temporal=2, n_spatial=2, config=CFG,
            max_iter=100, tol=1e-5, n_inits=2,
        )
        table = labeled.vaf_table()
        assert list(table.index.names) == ["subject", "trial"]
        per_subject = labeled.subject_table()
        assert list(per_subject.index) == ["s1", "s2"]
        with pytest.raises(ValueError, match="no subject labels"):
            result.subject_table()
        fig = plot_space_by_time(labeled.to_result(), show=False)
        plt.close(fig)


class TestMeshAxisGuard:
    """Meshes lacking the (data, time) axes warn and run locally."""

    def test_all_entries_fall_back_with_warning(self):
        from muscle_synergies_tpu import (
            analyze_dataset_space_by_time,
            analyze_dataset_time_varying,
        )
        from muscle_synergies_tpu.parallel.mesh import (
            DATA_AXIS,
            MODEL_AXIS,
        )

        trials = _trials()
        mesh = make_mesh((8, 1), axis_names=(DATA_AXIS, MODEL_AXIS))
        with pytest.warns(UserWarning, match="analyze_dataset: mesh"):
            res = analyze_dataset(
                trials, 200, ranks=(2,), config=CFG, mesh=mesh
            )
        ref = analyze_dataset(trials, 200, ranks=(2,), config=CFG)
        np.testing.assert_allclose(res.vaf_overall, ref.vaf_overall)
        with pytest.warns(UserWarning, match="time_varying: mesh"):
            analyze_dataset_time_varying(
                trials, 200, n_synergies=2, n_lags=5, config=CFG,
                mesh=mesh, max_iter=30,
            )
        with pytest.warns(UserWarning, match="space_by_time: mesh"):
            analyze_dataset_space_by_time(
                trials, 200, n_temporal=2, n_spatial=2, config=CFG,
                mesh=mesh, max_iter=30,
            )


class TestAnalyzeDatasetPipelined:
    """Parse/H2D/compute pipeline over capture files (dataset.py)."""

    def _arrays(self, b=5, n=400, l=6):
        rng = np.random.default_rng(7)
        return [
            np.maximum(
                np.abs(rng.standard_normal((n, 2)))
                @ rng.random((2, l))
                + 0.02 * rng.random((n, l)),
                0,
            )
            for _ in range(b)
        ]

    def test_batch_array_fast_path_matches_list(self):
        import jax.numpy as jnp

        trials = self._arrays()
        stacked = jnp.stack([jnp.asarray(t) for t in trials])
        for cfg in (CFG, PipelineConfig(reduce_to=100)):  # rms + envelope
            a = np.asarray(preprocess_trials(trials, 200, cfg))
            b = np.asarray(preprocess_trials(stacked, 200, cfg))
            np.testing.assert_array_equal(a, b)

    def test_pipelined_matches_oneshot(self):
        from muscle_synergies_tpu import analyze_dataset_pipelined

        trials = self._arrays()
        table = {f"t{i}": t for i, t in enumerate(trials)}
        paths = list(table)
        one = analyze_dataset(
            trials, 200, ranks=(1, 2), config=CFG, max_iter=300
        )
        # single chunk: identical batch shape -> exactly equal
        whole = analyze_dataset_pipelined(
            paths, 200, ranks=(1, 2), config=CFG, max_iter=300,
            chunk_files=len(paths), loader=table.__getitem__,
        )
        np.testing.assert_array_equal(one.vaf_overall, whole.vaf_overall)
        np.testing.assert_array_equal(one.w, whole.w)
        # chunked: float-reordering tolerance (GEMM blocking per chunk)
        chunked = analyze_dataset_pipelined(
            paths, 200, ranks=(1, 2), config=CFG, max_iter=300,
            chunk_files=2, prefetch=2, loader=table.__getitem__,
            subjects=["a", "a", "b", "b", "c"],
        )
        np.testing.assert_allclose(
            one.vaf_overall, chunked.vaf_overall, rtol=0, atol=1e-6
        )
        np.testing.assert_allclose(one.w, chunked.w, rtol=0, atol=1e-5)
        assert chunked.subjects == ["a", "a", "b", "b", "c"]
        assert chunked.sampling_frequency == 200.0
        assert chunked.n_iter.shape == one.n_iter.shape

    def test_real_captures_through_default_loader(self, tmp_path):
        from muscle_synergies_tpu import analyze_dataset_pipelined
        from muscle_synergies_tpu.testing import write_synthetic_capture

        paths = []
        for i in range(3):
            p = str(tmp_path / f"cap{i}.csv")
            write_synthetic_capture(
                p, state_len=40, n_trechos=1, n_cycles=1, seed=50 + i
            )
            paths.append(p)
        cfg = PipelineConfig(use_rms=True, rms_window_s=0.02, reduce_to=50)
        res = analyze_dataset_pipelined(
            paths, ranks=(1, 2), config=cfg, max_iter=200,
            chunk_files=2, prefetch=1,
        )
        assert res.vaf_overall.shape == (2, 3)
        assert res.sampling_frequency == 2000.0
        assert res.channel_names is not None
        assert res.channel_names[0] == "VL"

    def test_ragged_chunk_falls_back(self):
        from muscle_synergies_tpu import analyze_dataset_pipelined

        trials = self._arrays()
        trials[1] = trials[1][:350]  # ragged inside the first chunk
        table = {f"t{i}": t for i, t in enumerate(trials)}
        one = analyze_dataset(
            trials, 200, ranks=(1, 2), config=CFG, max_iter=300
        )
        chunked = analyze_dataset_pipelined(
            list(table), 200, ranks=(1, 2), config=CFG, max_iter=300,
            chunk_files=2, loader=table.__getitem__,
        )
        np.testing.assert_allclose(
            one.vaf_overall, chunked.vaf_overall, rtol=0, atol=1e-6
        )

    def test_validation(self):
        from muscle_synergies_tpu import analyze_dataset_pipelined

        trials = self._arrays(b=2)
        table = {f"t{i}": t for i, t in enumerate(trials)}
        with pytest.raises(ValueError, match="at least one path"):
            analyze_dataset_pipelined([], 200)
        with pytest.raises(ValueError, match="chunk_files"):
            analyze_dataset_pipelined(
                list(table), 200, chunk_files=0, loader=table.__getitem__
            )
        with pytest.raises(ValueError, match="subject labels"):
            analyze_dataset_pipelined(
                list(table), 200, subjects=["a"], loader=table.__getitem__
            )
        # bare arrays carry no rate: sampling_frequency= is required
        with pytest.raises(ValueError, match="sampling_frequency"):
            analyze_dataset_pipelined(
                list(table), config=CFG, loader=table.__getitem__
            )

    def test_fs_mismatch_raises(self):
        from muscle_synergies_tpu import analyze_dataset_pipelined

        class FakeCapture:
            def __init__(self, arr, fs):
                self.arr, self.sampling_frequency = arr, fs

            @property
            def coords(self):
                return [f"M{j}" for j in range(self.arr.shape[1])]

            @property
            def array(self):
                return self.arr

        trials = self._arrays(b=2)
        table = {
            "a": FakeCapture(trials[0], 200.0),
            "b": FakeCapture(trials[1], 500.0),
        }
        with pytest.raises(ValueError, match="sampling rate"):
            analyze_dataset_pipelined(
                list(table), ranks=(1,), config=CFG, max_iter=50,
                loader=table.__getitem__,
            )


class TestDatasetPrecisionKnob:
    """``precision`` threads through both dataset-level model families.

    CPU lowers every precision identically, so 'highest' must
    reproduce the default results exactly; the accuracy of both
    precisions on the card is measured by chip_smoke.py.
    """

    def test_time_varying_accepts_precision(self):
        from muscle_synergies_tpu import analyze_dataset_time_varying

        trials = _trials()
        kwargs = dict(n_synergies=2, n_lags=10, config=CFG,
                      max_iter=100, tol=1e-5, n_inits=2, seed=0)
        base = analyze_dataset_time_varying(trials, 200, **kwargs)
        hi = analyze_dataset_time_varying(
            trials, 200, precision="highest", **kwargs
        )
        np.testing.assert_allclose(hi.c, base.c, rtol=1e-12)
        np.testing.assert_array_equal(hi.n_iter, base.n_iter)

    def test_space_by_time_accepts_precision(self):
        from muscle_synergies_tpu import analyze_dataset_space_by_time

        trials = _trials()
        kwargs = dict(n_temporal=2, n_spatial=2, config=CFG,
                      max_iter=100, tol=1e-5, n_inits=2, seed=0)
        base = analyze_dataset_space_by_time(trials, 200, **kwargs)
        hi = analyze_dataset_space_by_time(
            trials, 200, precision="highest", **kwargs
        )
        np.testing.assert_allclose(
            hi.temporal_modules.to_numpy(),
            base.temporal_modules.to_numpy(), rtol=1e-12,
        )
        assert hi.vaf_overall == pytest.approx(base.vaf_overall,
                                               rel=1e-12)
