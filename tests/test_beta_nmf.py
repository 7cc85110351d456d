"""Beta-divergence MU solver parity vs sklearn (KL, IS, general beta).

The reference forwards **sklearn_kwargs into sklearn NMF (reference
analysis.py:718-720), so beta_loss must behave identically here.
Tests run in float64 on CPU (conftest) and share a custom init with
sklearn so trajectories are directly comparable.
"""

import numpy as np
import pytest
from sklearn.decomposition import NMF as SkNMF
from sklearn.decomposition._nmf import _beta_divergence

import muscle_synergies_tpu as mst
from muscle_synergies_tpu.models.beta import (
    beta_divergence,
    beta_loss_to_float,
    fit_mu_beta,
    mu_update_beta,
)

RNG = np.random.default_rng(42)
N, L, K = 60, 8, 3


@pytest.fixture(scope="module")
def problem():
    wt = RNG.random((N, 2))
    ht = RNG.random((2, L))
    x = wt @ ht + 0.02 * RNG.random((N, L))
    w0 = np.abs(RNG.standard_normal((N, K)))
    h0 = np.abs(RNG.standard_normal((K, L)))
    return x, w0, h0


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0, 1.5, 2.0, 2.5])
def test_divergence_matches_sklearn(problem, beta):
    x, w0, h0 = problem
    ours = float(beta_divergence(x, w0, h0, beta, square_root=True))
    ref = _beta_divergence(x, w0, h0, beta, square_root=True)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)


@pytest.mark.parametrize(
    "beta_loss", ["kullback-leibler", "itakura-saito", 0.5, 1.5]
)
def test_fit_matches_sklearn(problem, beta_loss):
    x, w0, h0 = problem
    sk = SkNMF(
        n_components=K, solver="mu", beta_loss=beta_loss, init="custom",
        max_iter=200, tol=1e-5,
    )
    w_sk = sk.fit_transform(x, W=w0.copy(), H=h0.copy())

    state = fit_mu_beta(
        x, w0, h0, beta=beta_loss_to_float(beta_loss),
        max_iter=200, tol=1e-5,
    )
    assert int(state.n_iter) == sk.n_iter_
    np.testing.assert_allclose(np.asarray(state.w), w_sk, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(state.h), sk.components_,
                               rtol=1e-7, atol=1e-10)


def test_single_update_matches_sklearn_step(problem):
    """One W+H update equals sklearn's update pair exactly (KL)."""
    from sklearn.decomposition._nmf import (
        _multiplicative_update_h,
        _multiplicative_update_w,
    )

    x, w0, h0 = problem
    w, h = w0.copy(), h0.copy()
    w, *_ = _multiplicative_update_w(x, w, h, 1.0, 0.0, 0.0, 1.0)
    h = _multiplicative_update_h(x, w, h, 1.0, 0.0, 0.0, 1.0)
    h[h < np.finfo(np.float64).eps] = 0.0

    wj, hj = mu_update_beta(x, w0, h0, beta=1.0)
    np.testing.assert_allclose(np.asarray(wj), w, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(hj), h, rtol=1e-12)


def test_nmfmodel_beta_loss_surface(problem):
    x, _, _ = problem
    model = mst.NMFModel(
        n_components=K, solver="mu", beta_loss="kullback-leibler",
        init="nndsvda", max_iter=300, tol=1e-5,
    )
    w = model.fit_transform(x)
    sk = SkNMF(
        n_components=K, solver="mu", beta_loss="kullback-leibler",
        init="nndsvda", max_iter=300, tol=1e-5,
    )
    w_sk = sk.fit_transform(x)
    assert model.n_iter_ == sk.n_iter_
    np.testing.assert_allclose(w, w_sk, rtol=1e-6, atol=1e-9)

    with pytest.raises(ValueError, match="beta_loss"):
        mst.NMFModel(n_components=K, solver="cd",
                     beta_loss="kullback-leibler").fit_transform(x)


def test_legacy_alpha_regularization_mapping(problem):
    """alpha=/regularization= reproduce sklearn<=0.24's UNSCALED penalties.

    That era applied alpha directly; modern sklearn scales alpha_W by
    n_features and alpha_H by n_samples.  So the legacy fit must equal
    a modern sklearn fit with dimension-compensated alphas.
    """
    x, w0, h0 = problem
    n, l = x.shape
    alpha = 0.05
    legacy = mst.NMFModel(
        n_components=K, solver="mu", alpha=alpha, regularization="both",
        init="custom", max_iter=100, tol=0.0,
    )
    w_legacy = legacy.fit_transform(x, w=w0.copy(), h=h0.copy())
    sk = SkNMF(
        n_components=K, solver="mu", alpha_W=alpha / l, alpha_H=alpha / n,
        init="custom", max_iter=100, tol=0.0,
    )
    w_sk = sk.fit_transform(x, W=w0.copy(), H=h0.copy())
    np.testing.assert_allclose(w_legacy, w_sk, rtol=1e-9)

    comp_only = mst.NMFModel(
        n_components=K, solver="mu", alpha=alpha,
        regularization="components", init="custom", max_iter=50, tol=0.0,
    )
    w_c = comp_only.fit_transform(x, w=w0.copy(), h=h0.copy())
    sk = SkNMF(
        n_components=K, solver="mu", alpha_W=0.0, alpha_H=alpha / n,
        init="custom", max_iter=50, tol=0.0,
    )
    w_sk = sk.fit_transform(x, W=w0.copy(), H=h0.copy())
    np.testing.assert_allclose(w_c, w_sk, rtol=1e-9)

    with pytest.raises(ValueError, match="regularization"):
        mst.NMFModel(n_components=K, alpha=0.1, regularization="bogus")


def test_reconstruction_err_uses_fitted_loss(problem):
    """reconstruction_err_ is the square-rooted fitted beta-divergence."""
    x, _, _ = problem
    ours = mst.NMFModel(n_components=K, solver="mu",
                        beta_loss="kullback-leibler", init="nndsvda",
                        max_iter=200, tol=1e-5)
    ours.fit(x)
    sk = SkNMF(n_components=K, solver="mu", beta_loss="kullback-leibler",
               init="nndsvda", max_iter=200, tol=1e-5)
    sk.fit(x)
    np.testing.assert_allclose(ours.reconstruction_err_,
                               sk.reconstruction_err_, rtol=1e-6)


def test_itakura_saito_rejects_zeros(problem):
    x, _, _ = problem
    x0 = x.copy()
    x0[0, 0] = 0.0
    with pytest.raises(ValueError, match="beta_loss <= 0"):
        mst.NMFModel(n_components=K, solver="mu",
                     beta_loss="itakura-saito").fit_transform(x0)


def test_kl_pallas_tail_chunk_matches_xla(problem):
    """max_iter not divisible by check_every: impls still agree."""
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch

    x, w0, h0 = problem
    xs = np.stack([x, x * 0.5 + 0.01])
    w0s, h0s = np.stack([w0] * 2), np.stack([h0] * 2)
    ref = fit_mu_beta_batch(xs, w0s, h0s, beta=1.0, max_iter=155, tol=1e-5)
    got = fit_mu_beta_batch(xs, w0s, h0s, beta=1.0, max_iter=155,
                            tol=1e-5, impl="pallas",
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_allclose(np.asarray(got.previous_error),
                               np.asarray(ref.previous_error),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-8, atol=1e-11)


def test_analyze_dataset_beta_guardrails(problem):
    x, _, _ = problem
    trials = [x, x * 0.5 + 0.01]
    with pytest.raises(ValueError, match="inner_iter"):
        mst.analyze_dataset(trials, 2000.0, ranks=(2,), solver="mu",
                            beta_loss="kullback-leibler", inner_iter=3)
    # the Triton kernels need a GPU: an explicit impl='pallas' raises
    # here instead of interpreting, and 'auto' runs XLA for any beta
    with pytest.raises(RuntimeError, match="GPU"):
        mst.analyze_dataset(
            trials, 2000.0, ranks=(2,), solver="mu", beta_loss=1.5,
            impl="pallas", max_iter=50, tol=1e-4,
        )
    res = mst.analyze_dataset(
        trials, 2000.0, ranks=(2,), solver="mu", beta_loss=1.5,
        impl="auto", max_iter=50, tol=1e-4,
    )
    assert res.vaf_overall.shape == (1, 2)


def test_find_synergies_passes_beta_loss_through(problem):
    x, _, _ = problem
    import pandas as pd

    df = pd.DataFrame(x, columns=[f"m{i}" for i in range(L)])
    res = mst.find_synergies(
        df, 2, solver="mu", beta_loss="kullback-leibler",
        max_iter=500, tol=1e-5,
    )
    assert res.components.shape == (2, L)
    assert res.vaf_values["All signals"].iloc[0] > 0.9


@pytest.mark.parametrize(
    "kwargs",
    [
        {"solver": "cd"},
        {"solver": "mu"},
        {"solver": "mu", "beta_loss": "kullback-leibler"},
    ],
    ids=["cd", "mu-frobenius", "mu-kl"],
)
def test_transform_uses_fitted_solver(problem, kwargs):
    """transform() matches sklearn's solver-aware projection."""
    x, _, _ = problem
    x2 = RNG.random((20, L)) + 0.01  # new data to project

    ours = mst.NMFModel(n_components=K, init="nndsvda", max_iter=300,
                        tol=1e-5, **kwargs)
    ours.fit(x)
    sk = SkNMF(n_components=K, init="nndsvda", max_iter=300, tol=1e-5,
               **kwargs)
    sk.fit(x)
    np.testing.assert_allclose(ours.components_, sk.components_,
                               rtol=1e-6, atol=1e-9)
    w_ours = ours.transform(x2)
    w_sk = sk.transform(x2)
    np.testing.assert_allclose(w_ours, w_sk, rtol=1e-5, atol=1e-8)


def test_batched_beta_matches_per_trial(problem):
    """fit_mu_beta_batch freezes converged trials like the single fit."""
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch

    x, w0, h0 = problem
    rng = np.random.default_rng(9)
    xs = np.stack([x, x * 0.5 + 0.01, rng.random(x.shape)])
    w0s = np.stack([w0] * 3)
    h0s = np.stack([h0] * 3)
    states = fit_mu_beta_batch(xs, w0s, h0s, beta=1.0, max_iter=300, tol=1e-5)
    for i in range(3):
        single = fit_mu_beta(xs[i], w0s[i], h0s[i], beta=1.0,
                             max_iter=300, tol=1e-5)
        assert int(states.n_iter[i]) == int(single.n_iter), i
        np.testing.assert_allclose(np.asarray(states.w[i]),
                                   np.asarray(single.w), rtol=1e-9)


def test_batched_sweep_with_beta_loss(problem):
    """find_synergies(sweep='batched', beta_loss='kullback-leibler')."""
    import pandas as pd

    x, _, _ = problem
    df = pd.DataFrame(x, columns=[f"m{i}" for i in range(L)])
    loop = mst.find_synergies(df, 1, 3, solver="mu",
                              beta_loss="kullback-leibler",
                              max_iter=300, tol=1e-5)
    bat = mst.find_synergies(df, 1, 3, solver="mu",
                             beta_loss="kullback-leibler",
                             max_iter=300, tol=1e-5, sweep="batched")
    for k in (1, 2, 3):
        assert bat.model[k].n_iter_ == loop.model[k].n_iter_, k
        np.testing.assert_allclose(bat.components[k].to_numpy(),
                                   loop.components[k].to_numpy(),
                                   rtol=1e-7, atol=1e-10)


def test_analyze_dataset_beta_loss(problem):
    """Dataset-scale KL analysis routes through the batched beta solver."""
    x, _, _ = problem
    rng = np.random.default_rng(17)
    trials = [x, x * 0.7 + 0.01, rng.random(x.shape) + 0.01]
    res = mst.analyze_dataset(
        trials, 2000.0, ranks=(1, 2), solver="mu",
        beta_loss="kullback-leibler", max_iter=200, tol=1e-4,
    )
    assert res.vaf_overall.shape == (2, 3)
    # KL optimizes KL-divergence, not Frobenius VAF, so rank
    # monotonicity is not guaranteed — check sanity instead
    assert np.all(np.isfinite(res.vaf_overall))
    assert np.all(res.n_iter > 0)

    with pytest.raises(ValueError, match="requires solver='mu'"):
        mst.analyze_dataset(trials, 2000.0, ranks=(1,), solver="cd",
                            beta_loss="kullback-leibler")


def test_kl_pallas_fit_matches_xla_batch(problem):
    """impl='pallas' KL fit: same n_iter/conv/factors as the XLA batch."""
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch

    x, w0, h0 = problem
    rng = np.random.default_rng(23)
    xs = np.stack([x, x * 0.6 + 0.02, rng.random(x.shape) + 0.01,
                   x ** 1.1]).astype(np.float64)
    w0s = np.stack([w0] * 4)
    h0s = np.stack([h0] * 4)

    ref = fit_mu_beta_batch(xs, w0s, h0s, beta=1.0, max_iter=150, tol=1e-5)
    got = fit_mu_beta_batch(xs, w0s, h0s, beta=1.0, max_iter=150,
                            tol=1e-5, impl="pallas",
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=1e-8, atol=1e-11)


@pytest.mark.parametrize("beta", [-0.5, 0.5, 1.5, 2.5])
def test_pallas_beta_fit_matches_xla_for_fractional_betas(problem, beta):
    """Any float beta runs on the kernel path and equals the XLA batch.

    sklearn's MU accepts arbitrary ``beta_loss`` floats and the
    reference forwards them via ``**kwargs`` (reference
    analysis.py:848-864); the kernel must cover the same surface.
    """
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch

    x, w0, h0 = problem
    xs = np.stack([x + 0.01, x * 0.6 + 0.02])  # positive for beta < 1
    w0s, h0s = np.stack([w0] * 2), np.stack([h0] * 2)
    ref = fit_mu_beta_batch(xs, w0s, h0s, beta=beta, max_iter=120, tol=1e-5)
    got = fit_mu_beta_batch(xs, w0s, h0s, beta=beta, max_iter=120,
                            tol=1e-5, impl="pallas",
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=1e-6, atol=1e-9)


def test_is_pallas_fit_matches_xla_batch(problem):
    """impl='pallas' Itakura-Saito fit equals the XLA batch."""
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch

    x, w0, h0 = problem
    xs = np.stack([x + 0.01, x * 0.6 + 0.02])  # strictly positive
    w0s, h0s = np.stack([w0] * 2), np.stack([h0] * 2)
    ref = fit_mu_beta_batch(xs, w0s, h0s, beta=0.0, max_iter=120, tol=1e-5)
    got = fit_mu_beta_batch(xs, w0s, h0s, beta=0.0, max_iter=120,
                            tol=1e-5, impl="pallas",
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=1e-6, atol=1e-9)


def test_transform_warns_on_exhausted_max_iter():
    from sklearn.exceptions import ConvergenceWarning

    rng = np.random.default_rng(47)
    x = rng.random((60, 8)) + 0.01
    model = mst.NMFModel(n_components=3, max_iter=400, tol=1e-6).fit(x)
    model.max_iter = 2  # force the projection to exhaust its budget
    with pytest.warns(ConvergenceWarning, match="Maximum number of"):
        model.transform(x)


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis unavailable")
@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(4, 40),
    l=st.integers(2, 10),
    k=st.integers(1, 5),
    beta=st.sampled_from([0.0, 0.5, 1.0, 1.5, 2.5]),
    seed=st.integers(0, 2**31 - 1),
)
def test_update_step_property_matches_sklearn(n, l, k, beta, seed):
    """One W+H update equals sklearn's pair for random shapes/betas."""
    from sklearn.decomposition._nmf import (
        _multiplicative_update_h,
        _multiplicative_update_w,
    )

    rng = np.random.default_rng(seed)
    x = rng.random((n, l)) + (0.01 if beta <= 0 else 0.0)
    w0 = np.abs(rng.standard_normal((n, k))) + 1e-3
    h0 = np.abs(rng.standard_normal((k, l))) + 1e-3

    gamma = 1.0 / (2.0 - beta) if beta < 1 else (
        1.0 / (beta - 1.0) if beta > 2 else 1.0
    )
    w, h = w0.copy(), h0.copy()
    w, *_ = _multiplicative_update_w(x, w, h, beta, 0.0, 0.0, gamma)
    if beta < 1:
        w[w < np.finfo(np.float64).eps] = 0.0
    h = _multiplicative_update_h(x, w, h, beta, 0.0, 0.0, gamma)
    if beta <= 1:
        h[h < np.finfo(np.float64).eps] = 0.0

    wj, hj = mu_update_beta(x, w0, h0, beta=beta)
    np.testing.assert_allclose(np.asarray(wj), w, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(hj), h, rtol=1e-9, atol=1e-12)


def test_nan_input_rejected_like_sklearn(problem):
    x, _, _ = problem
    x_nan = x.copy()
    x_nan[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        mst.NMFModel(n_components=2).fit_transform(x_nan)
    import pandas as pd

    df = pd.DataFrame(x_nan)
    with pytest.raises(ValueError, match="NaN"):
        mst.find_synergies(df, 1, 2, sweep="batched")


def test_explicit_regularization_none_means_no_penalties(problem):
    """sklearn 0.24: regularization=None disabled penalties entirely."""
    x, w0, h0 = problem
    none_reg = mst.NMFModel(
        n_components=K, solver="mu", alpha=0.5, regularization=None,
        init="custom", max_iter=60, tol=0.0,
    )
    w_none = none_reg.fit_transform(x, w=w0.copy(), h=h0.copy())
    plain = mst.NMFModel(
        n_components=K, solver="mu", init="custom", max_iter=60, tol=0.0,
    )
    w_plain = plain.fit_transform(x, w=w0.copy(), h=h0.copy())
    np.testing.assert_array_equal(w_none, w_plain)


def test_pipeline_config_forwards_beta_loss(problem):
    import pandas as pd

    from muscle_synergies_tpu.utils.config import PipelineConfig

    x, _, _ = problem
    df = pd.DataFrame(x, columns=[f"m{i}" for i in range(L)])
    cfg = PipelineConfig(solver="mu", beta_loss="kullback-leibler",
                         min_rank=2, max_rank=2, max_iter=300, tol=1e-5)
    res = cfg.find_synergies(df)
    direct = mst.find_synergies(df, 2, 2, solver="mu",
                                beta_loss="kullback-leibler",
                                max_iter=300, tol=1e-5)
    assert res.model[2].n_iter_ == direct.model[2].n_iter_


def test_checkpointed_sweep_validates_like_find_synergies(tmp_path, problem):
    import pandas as pd

    from muscle_synergies_tpu.utils import find_synergies_checkpointed

    x, _, _ = problem
    df = pd.DataFrame(x)
    with pytest.raises(ValueError, match="invalid number"):
        find_synergies_checkpointed(df, 3, 99, tmp_path / "c1")
    with pytest.raises(ValueError, match="invalid number"):
        find_synergies_checkpointed(df, 3, 2, tmp_path / "c2")

def test_transform_rejects_incompatible_solver_beta_pair(problem):
    """A hand-constructed cd+beta!=2 model must raise, not silently MU.

    Round-2 advisor finding: transform routed via ``beta != 2 or
    solver == 'mu'``, so an unpickled model with ``solver='cd'`` and a
    non-Frobenius loss transformed with the MU solver instead of
    raising fit_transform's error.
    """
    x, _, _ = problem
    model = mst.NMFModel(n_components=K, solver="mu",
                         beta_loss="kullback-leibler", max_iter=200)
    model.fit(x)
    model.solver = "cd"  # simulate an unpickled/mutated model
    with pytest.raises(ValueError, match="does not handle beta_loss"):
        model.transform(x)
