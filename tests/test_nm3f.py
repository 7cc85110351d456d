"""Space-by-time (NM3F) factorization vs a naive numpy oracle."""

import numpy as np
import pytest

from muscle_synergies_tpu.models.nm3f import (
    find_space_by_time_synergies,
    fit_nm3f,
    init_nm3f,
    nm3f_reconstruct,
    nm3f_update,
    normalize_modules,
    sbt_vaf,
)
from muscle_synergies_tpu.models.mu import EPSILON

RNG = np.random.default_rng(13)


def naive_reconstruct(w, a, s):
    return np.stack([w @ a[b] @ s for b in range(a.shape[0])])


def naive_update(xs, w, a, s):
    """The documented A-then-W-then-S MU step in plain numpy loops."""
    b = xs.shape[0]
    wtw = w.T @ w
    sst = s @ s.T
    a = a.copy()
    for i in range(b):
        num = w.T @ xs[i] @ s.T
        den = wtw @ a[i] @ sst
        den[den == 0] = EPSILON
        a[i] = a[i] * (num / den)

    num_w = sum(xs[i] @ s.T @ a[i].T for i in range(b))
    gram_w = sum(a[i] @ sst @ a[i].T for i in range(b))
    den_w = w @ gram_w
    den_w[den_w == 0] = EPSILON
    w = w * (num_w / den_w)

    wtw = w.T @ w
    num_s = sum(a[i].T @ w.T @ xs[i] for i in range(b))
    gram_s = sum(a[i].T @ wtw @ a[i] for i in range(b))
    den_s = gram_s @ s
    den_s[den_s == 0] = EPSILON
    s = s * (num_s / den_s)
    return w, a, s


def synthetic(b=6, t=80, p=3, q=2, l=6, seed=5):
    """Trials generated exactly from the space-by-time model."""
    rng = np.random.default_rng(seed)
    w = np.zeros((t, p))
    width = t // p
    for i in range(p):  # localized temporal bumps
        center = (i + 0.5) * width
        w[:, i] = np.exp(-0.5 * ((np.arange(t) - center) / (width / 3)) ** 2)
    s = rng.uniform(0.1, 1.0, size=(q, l))
    a = rng.uniform(0.1, 1.0, size=(b, p, q))
    return naive_reconstruct(w, a, s), w, a, s


class TestAgainstNaive:
    def test_reconstruct_matches(self):
        w = RNG.uniform(0, 1, (40, 3))
        a = RNG.uniform(0, 1, (4, 3, 2))
        s = RNG.uniform(0, 1, (2, 5))
        np.testing.assert_allclose(
            np.asarray(nm3f_reconstruct(w, a, s)),
            naive_reconstruct(w, a, s),
            rtol=1e-12,
        )

    def test_single_update_matches(self):
        xs = RNG.uniform(0.1, 1, (4, 30, 5))
        w = RNG.uniform(0.1, 1, (30, 3))
        a = RNG.uniform(0.1, 1, (4, 3, 2))
        s = RNG.uniform(0.1, 1, (2, 5))
        wj, aj, sj = nm3f_update(xs, w, a, s)
        wn, an, sn = naive_update(xs, w, a, s)
        np.testing.assert_allclose(np.asarray(aj), an, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(wj), wn, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(sj), sn, rtol=1e-10)

    def test_ten_chained_updates_match(self):
        xs = RNG.uniform(0.1, 1, (3, 24, 4))
        w = RNG.uniform(0.1, 1, (24, 2))
        a = RNG.uniform(0.1, 1, (3, 2, 2))
        s = RNG.uniform(0.1, 1, (2, 4))
        wj, aj, sj = w, a, s
        wn, an, sn = w.copy(), a.copy(), s.copy()
        for _ in range(10):
            wj, aj, sj = nm3f_update(
                xs, np.asarray(wj), np.asarray(aj), np.asarray(sj)
            )
            wn, an, sn = naive_update(xs, wn, an, sn)
        np.testing.assert_allclose(np.asarray(wj), wn, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(aj), an, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(sj), sn, rtol=1e-8)

    def test_error_monotone_under_updates(self):
        xs = RNG.uniform(0.1, 1, (4, 40, 6))
        w, a, s = init_nm3f(xs, 3, 2, seed=2)
        prev = np.inf
        for _ in range(20):
            w, a, s = nm3f_update(xs, np.asarray(w), np.asarray(a),
                                  np.asarray(s))
            err = float(np.linalg.norm(xs - naive_reconstruct(
                np.asarray(w), np.asarray(a), np.asarray(s))))
            assert err <= prev + 1e-9
            prev = err


class TestFit:
    def test_converges_and_recovers_model_data(self):
        xs, w_true, a_true, s_true = synthetic()
        best = 0.0
        for seed in range(3):
            w0, a0, s0 = init_nm3f(xs, 3, 2, seed=seed)
            import jax.numpy as jnp

            state = fit_nm3f(
                jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
                jnp.asarray(s0), max_iter=1500, tol=1e-8,
            )
            vaf = np.asarray(
                sbt_vaf(jnp.asarray(xs), state.w, state.a, state.s)
            )
            best = max(best, float(vaf.min()))
        assert best > 0.95

    def test_frozen_modules(self):
        """update_w/update_s=False freeze the modules bit-for-bit (the
        transform path: coefficients for new trials)."""
        import jax.numpy as jnp

        xs, w_true, a_true, s_true = synthetic()
        _, a0, _ = init_nm3f(xs, 3, 2, seed=1)
        state = fit_nm3f(
            jnp.asarray(xs), jnp.asarray(w_true), jnp.asarray(a0),
            jnp.asarray(s_true), max_iter=400, tol=1e-8,
            update_w=False, update_s=False,
        )
        np.testing.assert_array_equal(np.asarray(state.w), w_true)
        np.testing.assert_array_equal(np.asarray(state.s), s_true)
        # with the true modules fixed, coefficients recover the data
        vaf = np.asarray(sbt_vaf(jnp.asarray(xs), state.w, state.a, state.s))
        assert vaf.min() > 0.95

    def test_max_iter_is_a_hard_cap(self):
        """Like every solver here, a non-multiple max_iter clamps the
        tail chunk instead of overrunning (review finding)."""
        import jax.numpy as jnp

        xs, _, _, _ = synthetic(b=2)
        w0, a0, s0 = init_nm3f(xs, 2, 2, seed=4)
        state = fit_nm3f(jnp.asarray(xs), jnp.asarray(w0),
                         jnp.asarray(a0), jnp.asarray(s0),
                         max_iter=25, tol=1e-12)
        assert int(state.n_iter) == 25
        # the tail chunk matches 25 plain updates exactly
        w, a, s = w0, a0, s0
        for _ in range(25):
            w, a, s = nm3f_update(xs, np.asarray(w), np.asarray(a),
                                  np.asarray(s))
        np.testing.assert_allclose(np.asarray(state.w), np.asarray(w),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(state.a), np.asarray(a),
                                   rtol=1e-9)

    def test_nonnegativity(self):
        import jax.numpy as jnp

        xs, _, _, _ = synthetic()
        w0, a0, s0 = init_nm3f(xs, 3, 2, seed=7)
        state = fit_nm3f(jnp.asarray(xs), jnp.asarray(w0),
                         jnp.asarray(a0), jnp.asarray(s0), max_iter=100)
        assert float(np.asarray(state.w).min()) >= 0
        assert float(np.asarray(state.a).min()) >= 0
        assert float(np.asarray(state.s).min()) >= 0


class TestNormalize:
    def test_reconstruction_invariant_and_unit_norms(self):
        w = RNG.uniform(0, 1, (30, 3))
        a = RNG.uniform(0, 1, (4, 3, 2))
        s = RNG.uniform(0, 1, (2, 5))
        wn, an, sn = normalize_modules(w, a, s)
        np.testing.assert_allclose(
            np.asarray(nm3f_reconstruct(wn, an, sn)),
            naive_reconstruct(w, a, s),
            rtol=1e-10,
        )
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(wn), axis=0), 1.0, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(sn), axis=1), 1.0, rtol=1e-12
        )

    def test_zero_module_untouched(self):
        w = RNG.uniform(0, 1, (30, 3))
        w[:, 1] = 0.0
        a = RNG.uniform(0, 1, (2, 3, 2))
        s = RNG.uniform(0, 1, (2, 5))
        wn, an, sn = normalize_modules(w, a, s)
        assert np.all(np.isfinite(np.asarray(wn)))
        np.testing.assert_array_equal(np.asarray(wn)[:, 1], 0.0)


class TestFindSpaceByTime:
    def test_end_to_end_on_dataframes(self):
        import pandas

        xs, _, _, _ = synthetic()
        trials = [
            pandas.DataFrame(x, columns=[f"m{i}" for i in range(6)])
            for x in xs
        ]
        res = find_space_by_time_synergies(
            trials, 3, 2, max_iter=800, tol=1e-7, n_inits=3, seed=0
        )
        assert res.vaf > 0.9
        assert res.temporal_modules.shape == (80, 3)
        assert res.spatial_modules.shape == (2, 6)
        assert list(res.spatial_modules.columns) == [f"m{i}" for i in range(6)]
        assert res.coefficients.shape == (6, 3, 2)
        assert res.vaf_per_trial.shape == (6,)
        assert res.restart_errors.shape == (3,)
        np.testing.assert_allclose(
            np.linalg.norm(res.temporal_modules.to_numpy(), axis=0),
            1.0, rtol=1e-6,
        )

    def test_accepts_array_stack(self):
        xs, _, _, _ = synthetic(b=3)
        res = find_space_by_time_synergies(
            xs, 2, 2, max_iter=200, n_inits=2
        )
        assert res.coefficients.shape == (3, 2, 2)

    def test_validation(self):
        xs, _, _, _ = synthetic(b=2)
        with pytest.raises(ValueError, match="Negative"):
            find_space_by_time_synergies(-xs - 1.0, 2, 2)
        with pytest.raises(ValueError, match="NaN"):
            bad = xs.copy()
            bad[0, 0, 0] = np.nan
            find_space_by_time_synergies(bad, 2, 2)
        with pytest.raises(ValueError, match="n_temporal"):
            find_space_by_time_synergies(xs, 0, 2)
        with pytest.raises(ValueError, match="n_spatial"):
            find_space_by_time_synergies(xs, 2, 99)
        with pytest.raises(ValueError, match="n_inits"):
            find_space_by_time_synergies(xs, 2, 2, n_inits=0)
        with pytest.raises(ValueError, match="trial stack"):
            find_space_by_time_synergies(xs[0], 2, 2)

    def test_importable_from_package_root(self):
        import muscle_synergies_tpu as mst

        assert hasattr(mst, "find_space_by_time_synergies")
        assert hasattr(mst.models, "find_space_by_time_synergies")

    def test_plot(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from muscle_synergies_tpu.viz import plot_space_by_time

        xs, _, _, _ = synthetic(b=3)
        res = find_space_by_time_synergies(xs, 2, 2, max_iter=100,
                                           n_inits=2)
        fig = plot_space_by_time(res, show=False)
        assert fig is not None
        assert len(fig.axes) >= 3
        plt.close(fig)


class TestNM3FStability:
    def test_masked_full_mask_equals_unmasked(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.models import fit_nm3f_masked

        xs, _, _, _ = synthetic(b=3)
        w0, a0, s0 = init_nm3f(xs, 2, 2, seed=1)
        full = fit_nm3f(jnp.asarray(xs), jnp.asarray(w0),
                        jnp.asarray(a0), jnp.asarray(s0),
                        max_iter=80, tol=1e-6)
        masked = fit_nm3f_masked(
            jnp.asarray(xs), jnp.ones_like(jnp.asarray(xs)),
            jnp.asarray(w0), jnp.asarray(a0), jnp.asarray(s0),
            max_iter=80, tol=1e-6,
        )
        assert int(masked.n_iter) == int(full.n_iter)
        np.testing.assert_allclose(np.asarray(masked.w),
                                   np.asarray(full.w), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(masked.a),
                                   np.asarray(full.a), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(masked.s),
                                   np.asarray(full.s), rtol=1e-9)

    def test_masked_recovers_heldout(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.models import fit_nm3f_masked
        from muscle_synergies_tpu.models.nm3f import nm3f_reconstruct

        xs, _, _, _ = synthetic()
        rng = np.random.default_rng(0)
        mask = (rng.random(xs.shape) >= 0.15).astype(float)
        w0, a0, s0 = init_nm3f(xs * mask, 3, 2, seed=2)
        state = fit_nm3f_masked(
            jnp.asarray(xs), jnp.asarray(mask), jnp.asarray(w0),
            jnp.asarray(a0), jnp.asarray(s0), max_iter=1200, tol=1e-9,
        )
        rec = np.asarray(nm3f_reconstruct(state.w, state.a, state.s))
        err = np.linalg.norm((1 - mask) * (xs - rec)) / np.linalg.norm(xs)
        assert err < 0.08

    def test_cv_zero_padding_stays_zero(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.models import fit_nm3f_masked

        xs, _, _, _ = synthetic(b=3)
        w0, a0, s0 = init_nm3f(xs, 2, 1, seed=3)
        t, l = xs.shape[1], xs.shape[2]
        w0p = np.zeros((t, 3)); w0p[:, :2] = w0
        a0p = np.zeros((3, 3, 2)); a0p[:, :2, :1] = a0
        s0p = np.zeros((2, l)); s0p[:1] = s0
        state = fit_nm3f_masked(
            jnp.asarray(xs), jnp.ones_like(jnp.asarray(xs)),
            jnp.asarray(w0p), jnp.asarray(a0p), jnp.asarray(s0p),
            max_iter=50, tol=1e-6,
        )
        np.testing.assert_array_equal(np.asarray(state.w)[:, 2:], 0.0)
        np.testing.assert_array_equal(np.asarray(state.a)[:, 2:, :], 0.0)
        np.testing.assert_array_equal(np.asarray(state.a)[:, :, 1:], 0.0)
        np.testing.assert_array_equal(np.asarray(state.s)[1:], 0.0)

    def test_cv_picks_true_module_counts(self):
        from muscle_synergies_tpu.models import cv_space_by_time_selection

        xs, _, _, _ = synthetic(b=8, p=3, q=2)
        res = cv_space_by_time_selection(
            xs, pairs=[(1, 1), (2, 2), (3, 2)], n_repeats=3,
            max_iter=400, tol=1e-8,
        )
        assert res.test_error.shape == (3, 3)
        means = res.mean_test_error
        assert means[2] < means[0]  # the true (3, 2) beats (1, 1)
        assert res.best in ((2, 2), (3, 2))

    def test_bootstrap_modules_stable_on_model_data(self):
        from muscle_synergies_tpu.models import bootstrap_space_by_time

        xs, _, _, _ = synthetic(b=10)
        boot_w, boot_s = bootstrap_space_by_time(
            xs, 3, 2, n_boot=8, max_iter=300, tol=1e-7, seed=0
        )
        assert boot_w.similarities.shape == (8, 3)
        assert boot_s.similarities.shape == (8, 2)
        # model-generated data: the shared modules are recoverable
        # across trial resamples
        assert np.all(boot_w.mean > 0.8)
        assert np.all(boot_s.mean > 0.8)

    def test_meshed_bootstrap_matches_local(self):
        from muscle_synergies_tpu.models import bootstrap_space_by_time
        from muscle_synergies_tpu.parallel import make_mesh

        xs, _, _, _ = synthetic(b=8)
        local_w, local_s = bootstrap_space_by_time(
            xs, 3, 2, n_boot=5, max_iter=150, tol=1e-7, seed=0
        )
        meshed_w, meshed_s = bootstrap_space_by_time(
            xs, 3, 2, n_boot=5, max_iter=150, tol=1e-7, seed=0,
            mesh=make_mesh((4, 2)),  # n_boot=5 pads to 8 devices
        )
        np.testing.assert_allclose(
            meshed_w.reference_components, local_w.reference_components
        )
        np.testing.assert_allclose(
            meshed_w.similarities, local_w.similarities, atol=1e-9
        )
        np.testing.assert_allclose(
            meshed_s.similarities, local_s.similarities, atol=1e-9
        )

    def test_meshed_bootstrap_wrong_axes_fall_back(self):
        from muscle_synergies_tpu.models import bootstrap_space_by_time
        from muscle_synergies_tpu.parallel import make_mesh
        from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

        xs, _, _, _ = synthetic(b=6)
        with pytest.warns(UserWarning, match="lacks"):
            boot_w, _ = bootstrap_space_by_time(
                xs, 2, 2, n_boot=3, max_iter=60,
                mesh=make_mesh((8, 1), axis_names=(DATA_AXIS, MODEL_AXIS)),
            )
        assert boot_w.similarities.shape == (3, 2)


class TestTransform:
    def test_modules_frozen_and_coefficients_recovered(self):
        from muscle_synergies_tpu.models.nm3f import nm3f_transform

        xs, w, a, s = synthetic(b=5)
        state = nm3f_transform(xs, w, s, max_iter=3000, tol=1e-12)
        # W and S come back bit-for-bit; only A was solved
        np.testing.assert_array_equal(np.asarray(state.w), w)
        np.testing.assert_array_equal(np.asarray(state.s), s)
        rec = naive_reconstruct(w, np.asarray(state.a), s)
        rel = np.linalg.norm(rec - xs) / np.linalg.norm(xs)
        assert rel < 1e-3

    def test_single_trial_squeezes(self):
        from muscle_synergies_tpu.models.nm3f import nm3f_transform

        xs, w, a, s = synthetic(b=3)
        state = nm3f_transform(xs[0], w, s, max_iter=200)
        assert np.asarray(state.a).shape == a[0].shape

    def test_explicit_a0_is_respected(self):
        from muscle_synergies_tpu.models.nm3f import nm3f_transform

        xs, w, a, s = synthetic(b=2)
        state = nm3f_transform(
            xs, w, s, a0=np.zeros_like(a), max_iter=50
        )
        # multiplicative updates cannot leave an all-zero init
        np.testing.assert_array_equal(np.asarray(state.a), 0.0)


class TestEstimator:
    def test_fit_transform_and_roundtrip(self):
        from muscle_synergies_tpu.models import NM3FModel

        xs, w, a, s = synthetic(b=6)
        model = NM3FModel(3, 2, max_iter=800, tol=1e-10, n_inits=3)
        coeffs = model.fit_transform(xs)
        assert coeffs.shape == a.shape
        assert model.temporal_modules_.shape == w.shape
        assert model.spatial_modules_.shape == s.shape
        # unit-norm module conventions, as find_space_by_time returns
        np.testing.assert_allclose(
            np.linalg.norm(model.temporal_modules_, axis=0), 1.0,
            rtol=1e-6,
        )
        assert model.vaf_ > 0.99
        rec = model.inverse_transform(coeffs)
        rel = np.linalg.norm(rec - xs) / np.linalg.norm(xs)
        assert rel < 0.05

    def test_transform_new_trials_against_fitted_modules(self):
        from muscle_synergies_tpu.models import NM3FModel

        xs, w, a, s = synthetic(b=8)
        model = NM3FModel(3, 2, max_iter=800, tol=1e-10).fit(xs[:5])
        coeffs = model.transform(xs[5:])
        assert coeffs.shape == (3, 3, 2)
        rec = model.inverse_transform(coeffs)
        rel = np.linalg.norm(rec - xs[5:]) / np.linalg.norm(xs[5:])
        assert rel < 0.05

    def test_unfitted_and_bad_shapes_raise(self):
        from muscle_synergies_tpu.models import NM3FModel

        xs, _, _, _ = synthetic(b=4)
        model = NM3FModel(3, 2)
        with pytest.raises(ValueError, match="not fitted"):
            model.transform(xs)
        model.fit(xs)
        with pytest.raises(ValueError, match="samples"):
            model.transform(xs[:, : xs.shape[1] // 2, :])
        with pytest.raises(ValueError, match="expected"):
            model.transform(xs[0, 0])


class TestReviewRegressions:
    def test_transform_broadcasts_single_a0_across_batch(self):
        from muscle_synergies_tpu.models.nm3f import nm3f_transform

        xs, w, a, s = synthetic(b=3)
        one = np.full(a[0].shape, 0.5)
        state = nm3f_transform(xs, w, s, a0=one, max_iter=30)
        assert np.asarray(state.a).shape == a.shape

    def test_transform_rejects_wrong_a0_batch(self):
        from muscle_synergies_tpu.models.nm3f import nm3f_transform

        xs, w, a, s = synthetic(b=3)
        with pytest.raises(ValueError, match="batch 2"):
            nm3f_transform(xs, w, s, a0=a[:2], max_iter=10)

    def test_f32_stack_solves_in_f32(self):
        xs, _, _, _ = synthetic(b=4)
        res = find_space_by_time_synergies(
            xs.astype(np.float32), 2, 2, max_iter=50, n_inits=1
        )
        assert res.coefficients.dtype == np.float32
        assert res.temporal_modules.to_numpy().dtype == np.float32

    def test_mesh_without_time_axis_warns_and_falls_back(self):
        from muscle_synergies_tpu.parallel import make_mesh
        from muscle_synergies_tpu.parallel.mesh import (
            DATA_AXIS,
            MODEL_AXIS,
        )

        xs, _, _, _ = synthetic(b=8)
        kw = dict(max_iter=50, tol=1e-6, n_inits=1, seed=0)
        ref = find_space_by_time_synergies(xs, 2, 2, **kw)
        mesh = make_mesh((8, 1), axis_names=(DATA_AXIS, MODEL_AXIS))
        with pytest.warns(UserWarning, match="lacks"):
            got = find_space_by_time_synergies(xs, 2, 2, mesh=mesh, **kw)
        np.testing.assert_allclose(
            got.temporal_modules.to_numpy(),
            ref.temporal_modules.to_numpy(), rtol=1e-12,
        )


class TestSharedFactorModels:
    """Delis tMod/sMod: NM3F with one factor frozen at identity."""

    def test_temporal_model_recovers_planted_modules(self):
        from muscle_synergies_tpu.models import find_temporal_synergies

        rng = np.random.default_rng(7)
        t, p, l, b = 60, 3, 6, 8
        w_true = np.zeros((t, p))
        width = t // p
        for i in range(p):
            center = (i + 0.5) * width
            w_true[:, i] = np.exp(
                -0.5 * ((np.arange(t) - center) / (width / 3)) ** 2
            )
        a_true = rng.uniform(0.1, 1.0, (b, p, l))
        xs = np.einsum("tp,bpl->btl", w_true, a_true)
        res = find_temporal_synergies(
            xs, p, max_iter=2000, tol=1e-10, n_inits=4
        )
        assert res.vaf > 0.99
        assert np.all(res.vaf_per_trial > 0.99)
        assert res.temporal_modules.shape == (t, p)
        assert res.weights.shape == (b, p, l)
        np.testing.assert_allclose(
            np.linalg.norm(res.temporal_modules.to_numpy(), axis=0),
            1.0, rtol=1e-6,
        )
        # planted modules recoverable up to permutation
        from muscle_synergies_tpu.models import match_synergies

        m = match_synergies(
            w_true.T / np.linalg.norm(w_true, axis=0)[:, None],
            res.temporal_modules.to_numpy().T,
        )
        assert m.mean > 0.95

    def test_spatial_model_recovers_planted_modules(self):
        from muscle_synergies_tpu.models import (
            find_shared_spatial_synergies,
            match_synergies,
        )

        rng = np.random.default_rng(8)
        t, q, l, b = 40, 2, 6, 6
        s_true = rng.uniform(0.1, 1.0, (q, l))
        c_true = rng.uniform(0.0, 1.0, (b, t, q))
        xs = np.einsum("btq,ql->btl", c_true, s_true)
        res = find_shared_spatial_synergies(
            xs, q, max_iter=2000, tol=1e-10, n_inits=4
        )
        assert res.vaf > 0.99
        assert res.spatial_modules.shape == (q, l)
        assert res.activations.shape == (b, t, q)
        np.testing.assert_allclose(
            np.linalg.norm(res.spatial_modules.to_numpy(), axis=1),
            1.0, rtol=1e-6,
        )
        m = match_synergies(s_true, res.spatial_modules.to_numpy())
        assert m.mean > 0.95

    def test_spatial_model_carries_muscle_labels(self):
        import pandas as pd

        from muscle_synergies_tpu.models import (
            find_shared_spatial_synergies,
        )

        rng = np.random.default_rng(9)
        names = [f"M{j}" for j in range(5)]
        trials = [
            pd.DataFrame(rng.uniform(0.1, 1.0, (30, 5)), columns=names)
            for _ in range(4)
        ]
        res = find_shared_spatial_synergies(
            trials, 2, max_iter=100, n_inits=2
        )
        assert list(res.spatial_modules.columns) == names

    def test_reconstruction_beats_space_by_time_special_cases(self):
        """tMod/sMod are NM3F specializations: same data, frozen eye."""
        from muscle_synergies_tpu.models import find_temporal_synergies

        xs, w, a, s = synthetic(b=6)
        res = find_temporal_synergies(xs, 3, max_iter=500, tol=1e-8)
        # full freedom on the muscle side: must reconstruct at least as
        # well as the (3, 2)-constrained space-by-time fit
        sbt = find_space_by_time_synergies(
            xs, 3, 2, max_iter=500, tol=1e-8
        )
        assert res.vaf >= sbt.vaf - 1e-6

    def test_validation(self):
        from muscle_synergies_tpu.models import (
            find_shared_spatial_synergies,
            find_temporal_synergies,
        )

        xs, _, _, _ = synthetic(b=3)
        with pytest.raises(ValueError, match="n_temporal"):
            find_temporal_synergies(xs, 0)
        with pytest.raises(ValueError, match="n_spatial"):
            find_shared_spatial_synergies(xs, 99)
        with pytest.raises(ValueError, match="Negative"):
            find_temporal_synergies(-xs, 2)


class TestSharedFactorCV:
    """Module-count selection for the tMod/sMod specializations."""

    def test_temporal_cv_picks_true_count(self):
        from muscle_synergies_tpu.models import cv_temporal_selection

        rng = np.random.default_rng(10)
        t, p, l, b = 60, 3, 6, 8
        w_true = np.zeros((t, p))
        width = t // p
        for i in range(p):
            center = (i + 0.5) * width
            w_true[:, i] = np.exp(
                -0.5 * ((np.arange(t) - center) / (width / 3)) ** 2
            )
        a_true = rng.uniform(0.1, 1.0, (b, p, l))
        xs = np.einsum("tp,bpl->btl", w_true, a_true)
        res = cv_temporal_selection(
            xs, candidates=(1, 3), n_repeats=3, max_iter=300, tol=1e-8
        )
        assert res.test_error.shape == (3, 2)
        assert res.mean_test_error[1] < res.mean_test_error[0]
        assert res.best_rank == 3

    def test_spatial_cv_picks_true_count(self):
        from muscle_synergies_tpu.models import (
            cv_shared_spatial_selection,
        )

        rng = np.random.default_rng(11)
        t, q, l, b = 40, 2, 6, 6
        s_true = rng.uniform(0.1, 1.0, (q, l))
        c_true = rng.uniform(0.0, 1.0, (b, t, q))
        xs = np.einsum("btq,ql->btl", c_true, s_true)
        res = cv_shared_spatial_selection(
            xs, candidates=(1, 2), n_repeats=3, max_iter=300, tol=1e-8
        )
        assert res.mean_test_error[1] < res.mean_test_error[0]
        assert res.best_rank == 2

    def test_frozen_identity_survives_masked_fit(self):
        from muscle_synergies_tpu.models import fit_nm3f_masked

        rng = np.random.default_rng(12)
        xs = rng.uniform(0.1, 1.0, (3, 20, 4))
        mask = (rng.random(xs.shape) >= 0.1).astype(float)
        eye = np.eye(4)
        w0 = rng.uniform(0.1, 1.0, (20, 2))
        a0 = rng.uniform(0.1, 1.0, (3, 2, 4))
        st = fit_nm3f_masked(
            xs, mask, w0, a0, eye, max_iter=50, update_s=False
        )
        np.testing.assert_array_equal(np.asarray(st.s), eye)

    def test_candidate_validation(self):
        from muscle_synergies_tpu.models import cv_temporal_selection

        xs = np.abs(np.random.default_rng(13).standard_normal((3, 20, 4)))
        with pytest.raises(ValueError, match="outside"):
            cv_temporal_selection(xs, candidates=(0,))


class TestSharedFactorBootstrap:
    def test_temporal_bootstrap_stable_on_model_data(self):
        from muscle_synergies_tpu.models import (
            bootstrap_temporal_synergies,
        )

        rng = np.random.default_rng(14)
        t, p, l, b = 60, 3, 6, 10
        w_true = np.zeros((t, p))
        width = t // p
        for i in range(p):
            center = (i + 0.5) * width
            w_true[:, i] = np.exp(
                -0.5 * ((np.arange(t) - center) / (width / 3)) ** 2
            )
        a_true = rng.uniform(0.1, 1.0, (b, p, l))
        xs = np.einsum("tp,bpl->btl", w_true, a_true)
        boot = bootstrap_temporal_synergies(
            xs, p, n_boot=8, max_iter=300, tol=1e-7
        )
        assert boot.similarities.shape == (8, p)
        assert boot.reference_components.shape == (p, t)
        assert np.all(boot.mean > 0.8)

    def test_spatial_bootstrap_stable_on_model_data(self):
        from muscle_synergies_tpu.models import (
            bootstrap_shared_spatial_synergies,
        )

        rng = np.random.default_rng(15)
        t, q, l, b = 40, 2, 6, 10
        s_true = rng.uniform(0.1, 1.0, (q, l))
        c_true = rng.uniform(0.0, 1.0, (b, t, q))
        xs = np.einsum("btq,ql->btl", c_true, s_true)
        boot = bootstrap_shared_spatial_synergies(
            xs, q, n_boot=8, max_iter=300, tol=1e-7
        )
        assert boot.similarities.shape == (8, q)
        assert boot.reference_components.shape == (q, l)
        assert np.all(boot.mean > 0.8)

    def test_meshed_shared_factor_matches_local(self):
        from muscle_synergies_tpu.models import (
            bootstrap_shared_spatial_synergies,
            bootstrap_temporal_synergies,
        )
        from muscle_synergies_tpu.parallel import make_mesh

        xs, _, _, _ = synthetic(b=8)
        mesh = make_mesh((4, 2))
        for fn in (
            bootstrap_temporal_synergies,
            bootstrap_shared_spatial_synergies,
        ):
            local = fn(xs, 2, n_boot=5, max_iter=120, tol=1e-7, seed=0)
            meshed = fn(
                xs, 2, n_boot=5, max_iter=120, tol=1e-7, seed=0,
                mesh=mesh,
            )
            np.testing.assert_allclose(
                meshed.reference_components, local.reference_components
            )
            np.testing.assert_allclose(
                meshed.similarities, local.similarities, atol=1e-9
            )

    def test_module_count_validation(self):
        from muscle_synergies_tpu.models import (
            bootstrap_temporal_synergies,
        )

        xs, _, _, _ = synthetic(b=3)
        with pytest.raises(ValueError, match="outside"):
            bootstrap_temporal_synergies(xs, 0, n_boot=2)


class TestPrecisionKnob:
    """The ``precision`` argument threads through every entry point.

    On CPU all matmul precisions lower identically, so each call must
    reproduce the default path exactly — these tests pin the API
    (threading, jit-static hashability) while the accuracy of both
    precisions on the card is measured by ``chip_smoke.py``.
    """

    def test_fit_accepts_precision_spellings(self):
        import jax

        xs, *_ = synthetic()
        w0, a0, s0 = init_nm3f(xs, 3, 2, seed=3)
        base = fit_nm3f(xs, w0, a0, s0, max_iter=40)
        for precision in ("highest", jax.lax.Precision.HIGHEST):
            st = fit_nm3f(xs, w0, a0, s0, max_iter=40, precision=precision)
            np.testing.assert_allclose(st.w, base.w, rtol=1e-12)
            np.testing.assert_allclose(st.a, base.a, rtol=1e-12)
            np.testing.assert_allclose(st.s, base.s, rtol=1e-12)
            assert int(st.n_iter) == int(base.n_iter)

    def test_update_reconstruct_and_vaf_thread_precision(self):
        xs, w, a, s = synthetic()
        got = nm3f_update(xs, w, a, s, precision="highest")
        want = nm3f_update(xs, w, a, s)
        for g, wv in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(wv),
                                       rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(nm3f_reconstruct(w, a, s, precision="highest")),
            np.asarray(nm3f_reconstruct(w, a, s)), rtol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(sbt_vaf(xs, w, a, s, precision="highest")),
            np.asarray(sbt_vaf(xs, w, a, s)), rtol=1e-12,
        )

    def test_finders_and_model_accept_precision(self):
        from muscle_synergies_tpu.models.nm3f import (
            NM3FModel,
            find_shared_spatial_synergies,
            find_temporal_synergies,
        )

        xs, *_ = synthetic()
        res = find_space_by_time_synergies(
            xs, 3, 2, max_iter=30, n_inits=2, precision="highest"
        )
        base = find_space_by_time_synergies(xs, 3, 2, max_iter=30, n_inits=2)
        assert res.vaf == pytest.approx(base.vaf, rel=1e-12)
        rt = find_temporal_synergies(
            xs, 3, max_iter=20, n_inits=2, precision="highest"
        )
        rs = find_shared_spatial_synergies(
            xs, 2, max_iter=20, n_inits=2, precision="highest"
        )
        assert 0.0 < rt.vaf <= 1.0 and 0.0 < rs.vaf <= 1.0
        model = NM3FModel(3, 2, max_iter=30, n_inits=2,
                          precision="highest").fit(xs)
        coeffs = model.transform(xs[:2])
        assert coeffs.shape == (2, 3, 2)
        rec = model.inverse_transform(coeffs)
        assert rec.shape == (2, xs.shape[1], xs.shape[2])

    def test_sharded_fit_accepts_precision(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.parallel import make_mesh
        from muscle_synergies_tpu.parallel.nm3f import sharded_fit_nm3f

        xs, *_ = synthetic(b=8, t=80)
        w0, a0, s0 = init_nm3f(xs, 3, 2, seed=3)
        mesh = make_mesh((2, 4))
        base = sharded_fit_nm3f(
            jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
            jnp.asarray(s0), mesh, max_iter=40,
        )
        st = sharded_fit_nm3f(
            jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
            jnp.asarray(s0), mesh, max_iter=40, precision="highest",
        )
        np.testing.assert_allclose(
            np.asarray(st.w), np.asarray(base.w), rtol=1e-12
        )
        assert int(st.n_iter) == int(base.n_iter)
