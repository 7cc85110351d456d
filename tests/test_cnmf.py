"""Convolutive NMF (time-varying synergies) vs a naive numpy oracle."""

import numpy as np
import pytest

from muscle_synergies_tpu.models.cnmf import (
    cnmf_reconstruct,
    cnmf_update,
    fit_cnmf,
    fit_cnmf_batch,
    init_cnmf,
    normalize_synergies,
    tvaf,
)
from muscle_synergies_tpu.models.mu import EPSILON

RNG = np.random.default_rng(7)


def naive_reconstruct(c, s):
    """Direct triple loop over the model definition."""
    t, k = c.shape
    _, d, m = s.shape
    out = np.zeros((t, m))
    for ti in range(t):
        for di in range(d):
            if ti - di >= 0:
                out[ti] += c[ti - di] @ s[:, di, :]
    return out


def naive_update(x, c, s):
    """Smaragdis-style MU in plain numpy (S per-lag, C ratio-of-sums)."""
    t, k = c.shape
    _, d, m = s.shape

    def shifted(cmat, lag):
        out = np.zeros_like(cmat)
        if lag == 0:
            return cmat.copy()
        out[lag:] = cmat[: t - lag]
        return out

    xhat = naive_reconstruct(c, s)
    s_new = s.copy()
    for di in range(d):
        cd = shifted(c, di)
        num = cd.T @ x
        den = cd.T @ xhat
        den[den == 0] = EPSILON
        s_new[:, di, :] = s[:, di, :] * (num / den)

    xhat = naive_reconstruct(c, s_new)
    num = np.zeros_like(c)
    den = np.zeros_like(c)
    for di in range(d):
        gn = x @ s_new[:, di, :].T
        gd = xhat @ s_new[:, di, :].T
        num[: t - di if di else t] += gn[di:]
        den[: t - di if di else t] += gd[di:]
    den[den == 0] = EPSILON
    return c * (num / den), s_new


def synthetic(t=120, k=2, d=8, m=6, seed=3):
    """Data generated exactly from the model (recoverable)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((t, k))
    for ki in range(k):  # sparse bursts of activation
        for start in rng.choice(t - d, size=4, replace=False):
            c[start, ki] = rng.uniform(0.5, 2.0)
    s = rng.uniform(0, 1, size=(k, d, m))
    return naive_reconstruct(c, s), c, s


class TestAgainstNaive:
    def test_reconstruct_matches(self):
        c = RNG.uniform(0, 1, (50, 3))
        s = RNG.uniform(0, 1, (3, 5, 4))
        np.testing.assert_allclose(
            np.asarray(cnmf_reconstruct(c, s)),
            naive_reconstruct(c, s),
            rtol=1e-10,
        )

    def test_single_update_matches(self):
        x = RNG.uniform(0.1, 1, (60, 5))
        c = RNG.uniform(0.1, 1, (60, 2))
        s = RNG.uniform(0.1, 1, (2, 6, 5))
        cj, sj = cnmf_update(x, c, s)
        cn, sn = naive_update(x, c, s)
        np.testing.assert_allclose(np.asarray(sj), sn, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(cj), cn, rtol=1e-9)

    def test_ten_chained_updates_match(self):
        x = RNG.uniform(0.1, 1, (40, 4))
        c = RNG.uniform(0.1, 1, (40, 2))
        s = RNG.uniform(0.1, 1, (2, 4, 4))
        cj, sj = c, s
        cn, sn = c.copy(), s.copy()
        for _ in range(10):
            cj, sj = cnmf_update(x, np.asarray(cj), np.asarray(sj))
            cn, sn = naive_update(x, cn, sn)
        np.testing.assert_allclose(np.asarray(cj), cn, rtol=1e-7)
        np.testing.assert_allclose(np.asarray(sj), sn, rtol=1e-7)


class TestFit:
    def test_error_decreases_and_converges(self):
        x, _, _ = synthetic()
        c0, s0 = init_cnmf(x, 2, 8, seed=1)
        state = fit_cnmf(x, c0, s0, max_iter=2000, tol=1e-4)
        assert bool(state.converged)
        assert int(state.n_iter) < 2000
        err0 = np.linalg.norm(x - np.asarray(cnmf_reconstruct(c0, s0)))
        assert float(state.previous_error) < 0.5 * err0

    def test_recovers_synthetic_model(self):
        x, _, _ = synthetic()
        best = 0.0
        for seed in range(3):
            c0, s0 = init_cnmf(x, 2, 8, seed=seed)
            state = fit_cnmf(x, c0, s0, max_iter=600, tol=1e-6)
            best = max(
                best, float(tvaf(x, state.c, state.s))
            )
        assert best > 0.95

    def test_frozen_activations(self):
        x, c_true, _ = synthetic()
        c0, s0 = init_cnmf(x, 2, 8, seed=0)
        state = fit_cnmf(x, c_true, s0, max_iter=100, update_c=False)
        np.testing.assert_array_equal(np.asarray(state.c), c_true)

    def test_nonnegativity_preserved(self):
        x, _, _ = synthetic()
        c0, s0 = init_cnmf(x, 2, 8, seed=5)
        state = fit_cnmf(x, c0, s0, max_iter=100)
        assert float(np.asarray(state.c).min()) >= 0
        assert float(np.asarray(state.s).min()) >= 0

    def test_both_factors_frozen_rejected(self):
        x, _, _ = synthetic()
        c0, s0 = init_cnmf(x, 2, 8, seed=5)
        with pytest.raises(ValueError, match="both"):
            fit_cnmf(x, c0, s0, update_c=False, update_s=False)


class TestTransform:
    def test_recovers_activations_of_known_library(self):
        """With the TRUE synergies fixed, transform must recover the
        data nearly exactly (the model generated it)."""
        from muscle_synergies_tpu.models.cnmf import cnmf_transform

        x, c_true, s_true = synthetic()
        state = cnmf_transform(x, s_true, max_iter=2000, tol=1e-10)
        np.testing.assert_array_equal(np.asarray(state.s), s_true)
        rec = np.asarray(cnmf_reconstruct(state.c, state.s))
        err = np.linalg.norm(x - rec) / max(np.linalg.norm(x), 1e-12)
        assert err < 0.05

    def test_batched_with_shared_library(self):
        from muscle_synergies_tpu.models.cnmf import cnmf_transform

        xs = np.stack([synthetic(seed=i)[0] for i in range(3)])
        _, _, s = synthetic(seed=0)
        state = cnmf_transform(xs, s, max_iter=100, tol=1e-5)
        assert state.c.shape == (3, xs.shape[1], 2)
        for b in range(3):
            np.testing.assert_array_equal(np.asarray(state.s[b]), s)

    def test_explicit_c0_used(self):
        from muscle_synergies_tpu.models.cnmf import cnmf_transform

        x, _, s_true = synthetic()
        c0, _ = init_cnmf(x, 2, 8, seed=9)
        a = cnmf_transform(x, s_true, c0=c0, max_iter=50, tol=0.0)
        b = cnmf_transform(x, s_true, c0=c0, max_iter=50, tol=0.0)
        np.testing.assert_array_equal(np.asarray(a.c), np.asarray(b.c))


class TestBatched:
    def test_batch_matches_loop(self):
        xs = np.stack([synthetic(seed=i)[0] for i in range(4)])
        c0, s0 = init_cnmf(xs, 2, 8, seed=11)
        batch = fit_cnmf_batch(xs, c0, s0, max_iter=120, tol=1e-5)
        for b in range(4):
            single = fit_cnmf(xs[b], c0[b], s0[b], max_iter=120, tol=1e-5)
            assert int(batch.n_iter[b]) == int(single.n_iter)
            np.testing.assert_allclose(
                np.asarray(batch.c[b]), np.asarray(single.c), rtol=1e-10
            )
            np.testing.assert_allclose(
                np.asarray(batch.s[b]), np.asarray(single.s), rtol=1e-10
            )

    def test_batched_tvaf_shape(self):
        xs = np.stack([synthetic(seed=i)[0] for i in range(3)])
        c0, s0 = init_cnmf(xs, 2, 8, seed=2)
        state = fit_cnmf_batch(xs, c0, s0, max_iter=60)
        v = np.asarray(tvaf(xs, state.c, state.s))
        assert v.shape == (3,)
        assert np.all(v > 0)

    def test_batch_fit_freezes_converged_trials(self):
        """An easy trial stops early while a hard one keeps iterating,
        and each matches its own single-trial fit."""
        from muscle_synergies_tpu.models.cnmf import fit_cnmf

        easy, c_true, s_true = synthetic(seed=3)
        rng = np.random.default_rng(0)
        hard = rng.uniform(0.1, 1.0, easy.shape)  # unstructured noise
        xs = np.stack([easy, hard])
        c0, s0 = init_cnmf(xs, 2, 8, seed=4)
        got = fit_cnmf_batch(xs, c0, s0, max_iter=400, tol=1e-3)
        assert int(got.n_iter[0]) != int(got.n_iter[1])
        for i in range(2):
            one = fit_cnmf(xs[i], c0[i], s0[i], max_iter=400, tol=1e-3)
            assert int(one.n_iter) == int(got.n_iter[i])
            np.testing.assert_allclose(
                np.asarray(got.c[i]), np.asarray(one.c),
                rtol=1e-8, atol=1e-11,
            )


class TestFindTimeVaryingSynergies:
    def _frame(self):
        import pandas

        x, _, _ = synthetic()
        return pandas.DataFrame(
            x, columns=[f"m{i}" for i in range(x.shape[1])]
        )

    def test_end_to_end_on_dataframe(self):
        df = self._frame()
        from muscle_synergies_tpu import find_time_varying_synergies

        res = find_time_varying_synergies(
            df, 2, 8, max_iter=400, tol=1e-6, n_inits=3, seed=0
        )
        assert res.vaf > 0.9
        assert set(res.synergies) == {0, 1}
        assert res.synergies[0].shape == (8, 6)
        assert list(res.synergies[0].columns) == list(df.columns)
        assert res.activations.shape == (len(df), 2)
        assert res.restart_errors.shape == (3,)
        # winner actually is the argmin restart
        assert res.vaf_per_muscle.index.tolist() == list(df.columns)
        # synergies come back unit-norm
        for k in res.synergies:
            n = np.linalg.norm(res.synergies[k].to_numpy())
            assert abs(n - 1.0) < 1e-6

    def test_validation(self):
        import pandas

        from muscle_synergies_tpu import find_time_varying_synergies

        df = self._frame()
        with pytest.raises(ValueError, match="Negative"):
            find_time_varying_synergies(-df - 1.0, 2, 4)
        with pytest.raises(ValueError, match="NaN"):
            bad = df.copy()
            bad.iloc[0, 0] = np.nan
            find_time_varying_synergies(bad, 2, 4)
        with pytest.raises(ValueError, match="n_lags"):
            find_time_varying_synergies(df, 2, len(df) + 1)
        with pytest.raises(ValueError, match="n_synergies"):
            find_time_varying_synergies(df, 0, 4)
        with pytest.raises(ValueError, match="n_inits"):
            find_time_varying_synergies(df, 2, 4, n_inits=0)
        with pytest.raises(ValueError, match="2-D"):
            find_time_varying_synergies(
                pandas.Series(np.ones(5)).to_numpy(), 1, 2
            )

    def test_impl_pallas_raises_without_kernel(self):
        """The convolutive model has no kernel: 'pallas' raises, and
        'auto' runs the same XLA fit as 'xla'."""
        from muscle_synergies_tpu import find_time_varying_synergies

        df = self._frame()
        with pytest.raises(ValueError, match="no Pallas kernel"):
            find_time_varying_synergies(df, 2, 8, impl="pallas")
        ref = find_time_varying_synergies(
            df, 2, 8, max_iter=120, n_inits=2, impl="xla"
        )
        got = find_time_varying_synergies(
            df, 2, 8, max_iter=120, n_inits=2, impl="auto"
        )
        assert got.n_iter == ref.n_iter
        np.testing.assert_array_equal(
            got.activations.to_numpy(), ref.activations.to_numpy()
        )

    def test_impl_validation(self):
        from muscle_synergies_tpu import find_time_varying_synergies

        with pytest.raises(ValueError, match="unknown impl"):
            find_time_varying_synergies(self._frame(), 2, 8, impl="cuda")

    def test_importable_from_analysis_and_models(self):
        from muscle_synergies_tpu import analysis, models

        assert (
            analysis.find_time_varying_synergies
            is models.find_time_varying_synergies
        )

    def test_plot(self):
        from muscle_synergies_tpu import find_time_varying_synergies
        from muscle_synergies_tpu.viz import plot_time_varying_synergies

        res = find_time_varying_synergies(
            self._frame(), 2, 8, max_iter=60, n_inits=2
        )
        fig = plot_time_varying_synergies(res, show=False)
        assert fig is not None
        assert len(fig.axes) == 4
        import matplotlib.pyplot as plt

        plt.close(fig)


class TestCNMFModel:
    def test_fit_transform_surface(self):
        from muscle_synergies_tpu.models import CNMFModel

        x, _, _ = synthetic()
        model = CNMFModel(2, 8, max_iter=400, tol=1e-6, n_inits=3,
                          random_state=0)
        c = model.fit_transform(x)
        assert c.shape == (x.shape[0], 2)
        assert model.synergies_.shape == (2, 8, x.shape[1])
        assert model.n_components_ == 2 and model.n_lags_ == 8
        assert model.restart_errors_.shape == (3,)
        assert model.reconstruction_err_ == pytest.approx(
            model.restart_errors_.min()
        )
        norms = np.linalg.norm(model.synergies_.reshape(2, -1), axis=1)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-8)

    def test_matches_functional_entry_point(self):
        from muscle_synergies_tpu.models import CNMFModel
        from muscle_synergies_tpu import find_time_varying_synergies

        x, _, _ = synthetic()
        res = find_time_varying_synergies(
            x, 2, 8, max_iter=200, tol=1e-5, n_inits=2, seed=7
        )
        model = CNMFModel(2, 8, max_iter=200, tol=1e-5, n_inits=2,
                          random_state=7)
        c = model.fit_transform(x)
        np.testing.assert_array_equal(c, res.activations.to_numpy())
        assert model.n_iter_ == res.n_iter

    def test_transform_and_inverse(self):
        from muscle_synergies_tpu.models import CNMFModel

        x, _, _ = synthetic()
        model = CNMFModel(2, 8, max_iter=600, tol=1e-7, n_inits=3).fit(x)
        c_new = model.transform(x)  # project the training trial back
        assert c_new.shape == (x.shape[0], 2)
        rec = model.inverse_transform(c_new)
        vaf = 1 - ((x - rec) ** 2).sum() / (x ** 2).sum()
        assert vaf > 0.9

    def test_unfitted_transform_raises(self):
        from muscle_synergies_tpu.models import CNMFModel

        x, _, _ = synthetic()
        with pytest.raises(ValueError, match="not fitted"):
            CNMFModel(2, 8).transform(x)


class TestNormalize:
    def test_reconstruction_invariant(self):
        c = RNG.uniform(0, 1, (30, 3))
        s = RNG.uniform(0, 1, (3, 4, 5))
        cn, sn = normalize_synergies(c, s)
        np.testing.assert_allclose(
            np.asarray(cnmf_reconstruct(cn, sn)),
            naive_reconstruct(c, s),
            rtol=1e-10,
        )
        norms = np.linalg.norm(np.asarray(sn).reshape(3, -1), axis=1)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-12)

    def test_batched_and_zero_synergy(self):
        c = RNG.uniform(0, 1, (2, 30, 3))
        s = RNG.uniform(0, 1, (2, 3, 4, 5))
        s[0, 1] = 0.0
        cn, sn = normalize_synergies(c, s)
        assert np.all(np.isfinite(np.asarray(sn)))
        np.testing.assert_allclose(
            np.asarray(cnmf_reconstruct(cn[1], sn[1])),
            naive_reconstruct(c[1], s[1]),
            rtol=1e-10,
        )


class TestPrecisionKnob:
    """``precision`` threads through the convolutive XLA surface.

    On CPU all matmul precisions lower identically, so every call must
    reproduce the default path exactly — the API contract (threading,
    jit-static hashability) is what's pinned here; the chip-side
    accuracy story (bf16 einsums ~5.8e-3 vs f64 -> f32-level at
    ``"highest"``) is measured on the card by ``chip_smoke.py``.
    """

    def _problem(self, b=4, t=60, l=6, k=3, d=5):
        rng = np.random.default_rng(11)
        x = rng.uniform(0.1, 1.0, (t, l))
        xs = np.stack([x * (0.8 + 0.1 * i) for i in range(b)])
        c0, s0 = init_cnmf(xs, k, d, seed=2)
        return xs, c0, s0

    def test_fit_and_batch_match_default(self):
        import jax.numpy as jnp

        xs, c0, s0 = self._problem()
        base = fit_cnmf(
            jnp.asarray(xs[0]), jnp.asarray(c0[0]), jnp.asarray(s0[0]),
            max_iter=40,
        )
        for precision in ("highest", None):
            st = fit_cnmf(
                jnp.asarray(xs[0]), jnp.asarray(c0[0]), jnp.asarray(s0[0]),
                max_iter=40, precision=precision,
            )
            np.testing.assert_allclose(st.c, base.c, rtol=1e-12)
            assert int(st.n_iter) == int(base.n_iter)
        stb = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
            max_iter=40, precision="highest",
        )
        baseb = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), max_iter=40
        )
        np.testing.assert_allclose(stb.c, baseb.c, rtol=1e-12)

    def test_update_reconstruct_iterations_tvaf(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.models.cnmf import cnmf_iterations_batch

        xs, c0, s0 = self._problem()
        got = cnmf_update(jnp.asarray(xs[0]), jnp.asarray(c0[0]),
                          jnp.asarray(s0[0]), precision="highest")
        want = cnmf_update(jnp.asarray(xs[0]), jnp.asarray(c0[0]),
                           jnp.asarray(s0[0]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(cnmf_reconstruct(jnp.asarray(c0[0]),
                                        jnp.asarray(s0[0]),
                                        precision="highest")),
            np.asarray(cnmf_reconstruct(jnp.asarray(c0[0]),
                                        jnp.asarray(s0[0]))),
            rtol=1e-12,
        )
        ci, si = cnmf_iterations_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), 5,
            precision="highest",
        )
        cb, sb = cnmf_iterations_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), 5
        )
        np.testing.assert_allclose(np.asarray(ci), np.asarray(cb),
                                   rtol=1e-12)
        v = tvaf(jnp.asarray(xs[0]), jnp.asarray(c0[0]),
                 jnp.asarray(s0[0]), precision="highest")
        vb = tvaf(jnp.asarray(xs[0]), jnp.asarray(c0[0]),
                  jnp.asarray(s0[0]))
        np.testing.assert_allclose(float(v), float(vb), rtol=1e-12)

    def test_transform_finder_and_model(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.models.cnmf import (
            CNMFModel,
            cnmf_transform,
            find_time_varying_synergies,
        )

        xs, c0, s0 = self._problem()
        stb = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), max_iter=30
        )
        tr = cnmf_transform(jnp.asarray(xs[0]), stb.s[0], max_iter=20,
                            precision="highest")
        tb = cnmf_transform(jnp.asarray(xs[0]), stb.s[0], max_iter=20)
        np.testing.assert_allclose(np.asarray(tr.c), np.asarray(tb.c),
                                   rtol=1e-12)
        res = find_time_varying_synergies(
            xs[0], 2, 4, max_iter=30, n_inits=2, precision="highest"
        )
        base = find_time_varying_synergies(xs[0], 2, 4, max_iter=30,
                                           n_inits=2)
        assert res.vaf == pytest.approx(base.vaf, rel=1e-12)
        m = CNMFModel(2, 4, max_iter=30, n_inits=2,
                      precision="highest").fit(xs[0])
        act = m.transform(xs[0])
        assert act.shape == (xs.shape[1], 2)
        rec = m.inverse_transform(act)
        assert rec.shape == xs[0].shape

    def test_sharded_fits_accept_precision(self):
        import jax.numpy as jnp

        from muscle_synergies_tpu.parallel import make_mesh
        from muscle_synergies_tpu.parallel.cnmf import (
            sharded_fit_cnmf,
            sharded_fit_cnmf_tp,
        )
        from muscle_synergies_tpu.parallel.mesh import MODEL_AXIS
        from muscle_synergies_tpu.parallel.nmf import DATA_AXIS

        xs, c0, s0 = self._problem(l=8)
        base = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), max_iter=30
        )
        mesh = make_mesh((2, 4))
        sh = sharded_fit_cnmf(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), mesh,
            max_iter=30, precision="highest",
        )
        np.testing.assert_allclose(np.asarray(sh.c), np.asarray(base.c),
                                   rtol=0, atol=1e-5)
        mesh_tp = make_mesh((2, 4), axis_names=(DATA_AXIS, MODEL_AXIS))
        sh_tp = sharded_fit_cnmf_tp(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0), mesh_tp,
            max_iter=30, precision="highest",
        )
        np.testing.assert_allclose(np.asarray(sh_tp.c), np.asarray(base.c),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(np.asarray(sh_tp.n_iter),
                              np.asarray(base.n_iter))
