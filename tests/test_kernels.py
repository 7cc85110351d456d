"""Triton kernel parity (Pallas interpret mode on CPU) vs the XLA solvers.

The kernels also lower for the GPU here (``lowering_platforms=("cuda",)``
needs no card); the ``gpu``-marked test compiles and runs them on one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muscle_synergies_tpu.models.batch import mu_iterations_batch
from muscle_synergies_tpu.models.hals import fit_cd
from muscle_synergies_tpu.models.kernels import (
    cd_iterations_pallas,
    mu_iterations_pallas,
)

RNG = np.random.default_rng(55)
B, N, L, K = 8, 16, 8, 4


@pytest.fixture(scope="module")
def problem():
    xs = jnp.asarray(RNG.random((B, N, L)), dtype=jnp.float32)
    w = jnp.asarray(RNG.random((B, N, K)), dtype=jnp.float32)
    h = jnp.asarray(RNG.random((B, K, L)), dtype=jnp.float32)
    return xs, w, h


class TestMUKernel:
    def test_matches_xla_updates(self, problem):
        xs, w, h = problem
        wp, hp = mu_iterations_pallas(xs, w, h, 5, interpret=True)
        wx, hx = mu_iterations_batch(xs, w, h, 5)
        np.testing.assert_allclose(np.asarray(wp), np.asarray(wx),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(hp), np.asarray(hx),
                                   rtol=1e-4, atol=1e-6)

    def test_loss_decreases(self, problem):
        xs, w, h = problem
        w1, h1 = mu_iterations_pallas(xs, w, h, 1, interpret=True)
        w9, h9 = mu_iterations_pallas(xs, w, h, 30, interpret=True)
        l1 = float(jnp.linalg.norm(xs - w1 @ h1))
        l9 = float(jnp.linalg.norm(xs - w9 @ h9))
        assert l9 < l1

    def test_pack_pads_samples_with_zeros(self, problem):
        from muscle_synergies_tpu.models.kernels._triton import pack, unpack

        xs, w, _ = problem
        xs, w = xs[:, :13], w[:, :13]  # N = 13 pads to 16
        xt, wt = pack(xs, w)
        assert xt.shape == (B, L, 16) and wt.shape == (B, K, 16)
        assert not np.any(np.asarray(xt[:, :, 13:]))
        assert not np.any(np.asarray(wt[:, :, 13:]))
        np.testing.assert_array_equal(np.asarray(unpack(wt, 13)),
                                      np.asarray(w))

    def test_inner_iter_matches_xla_accelerated_mu(self, problem):
        # accelerated MU (Gram reuse) must agree with the XLA
        # mu_update(inner_iter=...) trajectory exactly
        xs, w, h = problem
        wp, hp = mu_iterations_pallas(
            xs, w, h, 4, interpret=True, inner_iter=3
        )
        wx, hx = mu_iterations_batch(xs, w, h, 4, inner_iter=3)
        np.testing.assert_allclose(np.asarray(wp), np.asarray(wx),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(hp), np.asarray(hx),
                                   rtol=1e-4, atol=1e-6)

    def test_inner_iter_accelerates_per_outer_iteration(self, problem):
        xs, w, h = problem
        w1, h1 = mu_iterations_pallas(
            xs, w, h, 10, interpret=True, inner_iter=1
        )
        w3, h3 = mu_iterations_pallas(
            xs, w, h, 10, interpret=True, inner_iter=3
        )
        l1 = float(jnp.linalg.norm(xs - w1 @ h1))
        l3 = float(jnp.linalg.norm(xs - w3 @ h3))
        assert l3 < l1


class TestCDKernel:
    def test_matches_xla_solver(self, problem):
        xs, w, h = problem
        wp, hp = cd_iterations_pallas(xs, w, h, 5, interpret=True)
        ref = jax.vmap(
            lambda x, w0, h0: fit_cd(x, w0, h0, max_iter=5, tol=0.0)
        )(xs, w, h)
        np.testing.assert_allclose(
            np.asarray(wp), np.asarray(ref.w), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(hp),
            np.asarray(jnp.swapaxes(ref.ht, -1, -2)),
            rtol=1e-4,
            atol=1e-5,
        )

    def test_nonnegative_outputs(self, problem):
        xs, w, h = problem
        wp, hp = cd_iterations_pallas(xs, w, h, 10, interpret=True)
        assert float(jnp.min(wp)) >= 0.0
        assert float(jnp.min(hp)) >= 0.0


class TestFitMUKernel:
    def test_exact_stopping_parity_with_xla_fit(self, problem):
        from muscle_synergies_tpu.models.batch import fit_mu_batch
        from muscle_synergies_tpu.models.kernels import fit_mu_pallas

        xs, w, h = problem
        # structured data so trials converge at different iterations
        rng = np.random.default_rng(4)
        wt = rng.random((B, N, 2))
        ht = rng.random((B, 2, L))
        xs2 = jnp.asarray(wt @ ht + 0.01 * rng.random((B, N, L)),
                          dtype=jnp.float32)
        wp, hp, n_iter, prev_err, conv = fit_mu_pallas(
            xs2, w, h, max_iter=2000, tol=1e-5, interpret=True
        )
        ref = fit_mu_batch(xs2, w, h, max_iter=2000, tol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(n_iter), np.asarray(ref.n_iter)
        )
        np.testing.assert_array_equal(
            np.asarray(conv), np.asarray(ref.converged)
        )
        np.testing.assert_allclose(
            np.asarray(wp), np.asarray(ref.w), rtol=1e-4, atol=1e-5
        )
        # same field semantics as the XLA path: error at each trial's
        # last convergence check, not a freshly recomputed final error
        np.testing.assert_allclose(
            np.asarray(prev_err), np.asarray(ref.previous_error),
            rtol=1e-4, atol=1e-6,
        )

    def test_max_iter_cap(self, problem):
        from muscle_synergies_tpu.models.kernels import fit_mu_pallas

        xs, w, h = problem
        _, _, n_iter, _, conv = fit_mu_pallas(
            xs, w, h, max_iter=30, tol=1e-12, interpret=True
        )
        assert np.all(np.asarray(n_iter) == 30)
        assert not np.any(np.asarray(conv))

    def test_tol_zero_disables_convergence_check(self, problem):
        """tol=0 must run to max_iter, like the XLA fit's static branch.

        A near-converged f32 trial can see its Frobenius error tick up
        at a checkpoint; with tol=0 the kernel must not interpret that
        as convergence (reference point: sklearn treats tol=0 as "run
        all of max_iter").
        """
        from muscle_synergies_tpu.models.kernels import fit_mu_pallas

        xs, w, h = problem
        # structured, fast-converging data maximizes the chance of an
        # error uptick at some checkpoint
        rng = np.random.default_rng(11)
        wt = rng.random((B, N, 2))
        ht = rng.random((B, 2, L))
        xs2 = jnp.asarray(wt @ ht, dtype=jnp.float32)
        wp, hp, n_iter, prev_err, conv = fit_mu_pallas(
            xs2, w, h, max_iter=200, tol=0.0, interpret=True
        )
        assert np.all(np.asarray(n_iter) == 200)
        assert not np.any(np.asarray(conv))
        # factors equal the plain 200-iteration run (no frozen trials)
        wi, hi = mu_iterations_pallas(xs2, w, h, 200,
                                      interpret=True)
        np.testing.assert_allclose(np.asarray(wp), np.asarray(wi),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(hp), np.asarray(hi),
                                   rtol=1e-6, atol=1e-7)


def test_fit_mu_batch_pallas_impl(problem=None):
    from muscle_synergies_tpu.models.batch import fit_mu_batch, init_batch

    rng = np.random.default_rng(7)
    wt = rng.random((8, 32, 2))
    ht = rng.random((8, 2, 6))
    xs = jnp.asarray(wt @ ht + 0.01 * rng.random((8, 32, 6)),
                     dtype=jnp.float32)
    w0, h0 = init_batch(xs, 2, init="nndsvda")
    w0, h0 = w0.astype(jnp.float32), h0.astype(jnp.float32)
    state_p = fit_mu_batch(xs, w0, h0, max_iter=500, tol=1e-5,
                           impl="pallas", interpret=True)
    state_x = fit_mu_batch(xs, w0, h0, max_iter=500, tol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(state_p.n_iter), np.asarray(state_x.n_iter)
    )
    np.testing.assert_allclose(
        np.asarray(state_p.w), np.asarray(state_x.w), rtol=1e-4, atol=1e-5
    )


class TestKLKernel:
    def test_matches_beta_updates(self, problem):
        from muscle_synergies_tpu.models.beta import mu_update_beta
        from muscle_synergies_tpu.models.kernels import kl_mu_iterations_pallas

        xs, w, h = problem
        wp, hp = kl_mu_iterations_pallas(xs, w, h, 7,
                                         interpret=True)
        wr, hr = w, h
        for _ in range(7):
            out = jax.vmap(lambda x, wi, hi: mu_update_beta(x, wi, hi, 1.0))(
                xs, wr, hr
            )
            wr, hr = out
        np.testing.assert_allclose(np.asarray(wp), np.asarray(wr),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(hp), np.asarray(hr),
                                   rtol=1e-4, atol=1e-6)

    def test_kl_divergence_decreases(self, problem):
        from muscle_synergies_tpu.models.beta import beta_divergence
        from muscle_synergies_tpu.models.kernels import kl_mu_iterations_pallas

        xs, w, h = problem
        w1, h1 = kl_mu_iterations_pallas(xs, w, h, 1,
                                         interpret=True)
        w30, h30 = kl_mu_iterations_pallas(xs, w, h, 30,
                                           interpret=True)
        d1 = sum(float(beta_divergence(xs[i], w1[i], h1[i], 1.0))
                 for i in range(B))
        d30 = sum(float(beta_divergence(xs[i], w30[i], h30[i], 1.0))
                  for i in range(B))
        assert d30 < d1


def test_is_kernel_matches_beta_updates(problem):
    """Itakura-Saito kernel vs the XLA beta updates (beta=0)."""
    from muscle_synergies_tpu.models.beta import mu_update_beta
    from muscle_synergies_tpu.models.kernels import beta_mu_iterations_pallas

    xs, w, h = problem
    xs = xs + 0.05  # strictly positive for IS
    wp, hp = beta_mu_iterations_pallas(xs, w, h, 6, beta=0.0,
                                       interpret=True)
    wr, hr = w, h
    for _ in range(6):
        wr, hr = jax.vmap(lambda x, wi, hi: mu_update_beta(x, wi, hi, 0.0))(
            xs, wr, hr
        )
    np.testing.assert_allclose(np.asarray(wp), np.asarray(wr),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(hp), np.asarray(hr),
                               rtol=1e-4, atol=1e-6)


class TestFitCDKernel:
    def test_exact_stopping_parity_with_xla_fit(self, problem):
        from muscle_synergies_tpu.models.batch import fit_cd_batch
        from muscle_synergies_tpu.models.kernels import fit_cd_pallas

        xs, w, h = problem
        rng = np.random.default_rng(5)
        wt = rng.random((B, N, 2))
        ht = rng.random((B, 2, L))
        xs2 = jnp.asarray(wt @ ht + 0.01 * rng.random((B, N, L)),
                          dtype=jnp.float32)
        wp, hp, n_iter, viol_init, conv = fit_cd_pallas(
            xs2, w, h, max_iter=500, tol=1e-4, interpret=True
        )
        ref = fit_cd_batch(xs2, w, h, max_iter=500, tol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(n_iter), np.asarray(ref.n_iter)
        )
        np.testing.assert_array_equal(
            np.asarray(conv), np.asarray(ref.converged)
        )
        np.testing.assert_allclose(
            np.asarray(wp), np.asarray(ref.w), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(hp), np.asarray(jnp.swapaxes(ref.ht, -1, -2)),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(viol_init), np.asarray(ref.violation_init),
            rtol=1e-4,
        )

    def test_batch_impl_pallas_roundtrip(self, problem):
        """fit_cd_batch(impl='pallas') returns a CDState-shaped result."""
        from muscle_synergies_tpu.models.batch import fit_cd_batch

        xs, w, h = problem
        state = fit_cd_batch(
            xs, w, h, max_iter=50, tol=1e-4, impl="pallas", interpret=True
        )
        assert state.w.shape == (B, N, K)
        assert state.ht.shape == (B, L, K)

    def test_max_iter_cap(self, problem):
        from muscle_synergies_tpu.models.kernels import fit_cd_pallas

        xs, w, h = problem
        _, _, n_iter, _, conv = fit_cd_pallas(
            xs, w, h, max_iter=20, tol=0.0, interpret=True
        )
        assert np.all(np.asarray(n_iter) == 20)
        assert not np.any(np.asarray(conv))


class TestPadding:
    """Ragged shapes: the wrappers pad samples to a power of two, and
    the padding must not change the factors."""

    @pytest.fixture(scope="class")
    def ragged(self):
        rng = np.random.default_rng(8)
        b, n, l, k = 9, 20, 6, 3  # odd batch, non-power-of-two N and L
        wt = rng.random((b, n, 2))
        ht = rng.random((b, 2, l))
        xs = jnp.asarray(wt @ ht + 0.01 * rng.random((b, n, l)), jnp.float32)
        w = jnp.asarray(rng.random((b, n, k)), jnp.float32)
        h = jnp.asarray(rng.random((b, k, l)), jnp.float32)
        return xs, w, h

    @pytest.mark.parametrize("n_trials", [1, 2, 4, 8])
    def test_mu_fit_any_block_matches_xla(self, ragged, n_trials):
        """Any batch size: the grid launches one program per trial."""
        from muscle_synergies_tpu.models.batch import fit_mu_batch
        from muscle_synergies_tpu.models.kernels import fit_mu_pallas

        xs, w, h = (a[:n_trials] for a in ragged)
        wp, hp, n_iter, _, conv = fit_mu_pallas(
            xs, w, h, max_iter=300, tol=1e-5, interpret=True,
        )
        ref = fit_mu_batch(xs, w, h, max_iter=300, tol=1e-5)
        assert wp.shape == xs.shape[:2] + (w.shape[-1],)
        assert hp.shape == h.shape
        np.testing.assert_array_equal(np.asarray(n_iter),
                                      np.asarray(ref.n_iter))
        np.testing.assert_allclose(np.asarray(wp), np.asarray(ref.w),
                                   rtol=1e-4, atol=1e-5)

    def test_cd_fit_padding_matches_xla(self, ragged):
        from muscle_synergies_tpu.models.batch import fit_cd_batch
        from muscle_synergies_tpu.models.kernels import fit_cd_pallas

        xs, w, h = ragged
        wp, hp, n_iter, viol, conv = fit_cd_pallas(
            xs, w, h, max_iter=300, tol=1e-4, interpret=True
        )
        ref = fit_cd_batch(xs, w, h, max_iter=300, tol=1e-4)
        np.testing.assert_array_equal(np.asarray(n_iter),
                                      np.asarray(ref.n_iter))
        np.testing.assert_allclose(
            np.asarray(hp), np.asarray(jnp.swapaxes(ref.ht, -1, -2)),
            rtol=1e-4, atol=1e-5,
        )

    @pytest.mark.parametrize("beta", [1.0, 0.0, 1.5, -0.5])
    def test_beta_padding_matches_xla(self, ragged, beta):
        from muscle_synergies_tpu.models.beta import mu_update_beta
        from muscle_synergies_tpu.models.kernels import (
            beta_mu_iterations_pallas,
        )

        xs, w, h = ragged
        xs = xs + 0.05
        wp, hp = beta_mu_iterations_pallas(
            xs, w, h, 4, beta=beta, interpret=True
        )
        wr, hr = w, h
        for _ in range(4):
            wr, hr = jax.vmap(
                lambda x, a, b: mu_update_beta(x, a, b, beta)
            )(xs, wr, hr)
        assert np.all(np.isfinite(np.asarray(wp)))
        np.testing.assert_allclose(np.asarray(wp), np.asarray(wr),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(hp), np.asarray(hr),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("family", ["mu", "cd"])
    def test_each_trial_stops_on_its_own(self, ragged, family):
        """A trial's fit in a batch equals its fit alone: no trial's
        stopping iteration or factors depend on its neighbours."""
        from muscle_synergies_tpu.models.kernels import (
            fit_cd_pallas,
            fit_mu_pallas,
        )

        fit = fit_mu_pallas if family == "mu" else fit_cd_pallas
        xs, w, h = ragged
        wb, hb, nb, _, cb = fit(xs, w, h, max_iter=400, tol=1e-4,
                                interpret=True)
        assert len(set(np.asarray(nb).tolist())) > 1
        for i in (0, xs.shape[0] - 1):
            wi, hi, ni, _, ci = fit(xs[i:i + 1], w[i:i + 1], h[i:i + 1],
                                    max_iter=400, tol=1e-4, interpret=True)
            assert int(ni[0]) == int(nb[i]) and bool(ci[0]) == bool(cb[i])
            np.testing.assert_array_equal(np.asarray(wi[0]),
                                          np.asarray(wb[i]))
            np.testing.assert_array_equal(np.asarray(hi[0]),
                                          np.asarray(hb[i]))


_SHAPES = (
    jax.ShapeDtypeStruct((5, 200, 8), jnp.float32),
    jax.ShapeDtypeStruct((5, 200, 4), jnp.float32),
    jax.ShapeDtypeStruct((5, 4, 8), jnp.float32),
)


def _kernel_calls():
    from muscle_synergies_tpu.models import kernels as k

    return {
        "mu_iterations": lambda: k.mu_iterations_pallas.trace(*_SHAPES, 3),
        "mu_fit": lambda: k.fit_mu_pallas.trace(*_SHAPES, max_iter=50),
        "cd_iterations": lambda: k.cd_iterations_pallas.trace(*_SHAPES, 3),
        "cd_fit": lambda: k.fit_cd_pallas.trace(*_SHAPES, max_iter=50),
        "kl_iterations": lambda: k.beta_mu_iterations_pallas.trace(
            *_SHAPES, 3, beta=1.0),
        "is_iterations": lambda: k.beta_mu_iterations_pallas.trace(
            *_SHAPES, 3, beta=0.0),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_lowers_for_cuda(name):
    """Each kernel lowers to Triton IR for the GPU (no card needed)."""
    lowered = _kernel_calls()[name]().lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text().lower()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mu", "cd", "kl"])
def test_compiled_kernel_fit_matches_xla(gpu, family):
    """On a card: the compiled kernel fit agrees with the XLA fit."""
    from muscle_synergies_tpu.models import batch as mb

    rng = np.random.default_rng(2)
    xs = jnp.asarray(rng.random((64, 200, 8)), jnp.float32)
    w = jnp.asarray(rng.random((64, 200, 4)), jnp.float32)
    h = jnp.asarray(rng.random((64, 4, 8)), jnp.float32)
    fit = {
        "mu": mb.fit_mu_batch, "cd": mb.fit_cd_batch,
        "kl": lambda *a, **kw: mb.fit_mu_beta_batch(*a, beta=1.0, **kw),
    }[family]
    got = fit(xs, w, h, max_iter=100, tol=0.0, impl="pallas")
    want = fit(xs, w, h, max_iter=100, tol=0.0, impl="xla")
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w),
                               rtol=2e-3, atol=1e-5)
