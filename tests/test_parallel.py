"""Distributed-path tests on a virtual 8-device CPU mesh.

Every sharded computation must equal its single-device counterpart
exactly (up to float reordering): sequence parallelism here is exact,
not approximate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal as sps

from muscle_synergies_tpu.models import fit_mu, initialize_nmf
from muscle_synergies_tpu.models.batch import (
    fit_cd_batch,
    fit_mu_batch,
    init_batch,
    pad_and_stack,
    rank_sweep_batch,
    vaf_batch,
)
from muscle_synergies_tpu.ops import sos_design, sosfilt, sosfiltfilt
from muscle_synergies_tpu.parallel import (
    make_mesh,
    sharded_fit_mu,
    sharded_mu_step,
    sharded_sosfilt,
    sharded_sosfiltfilt,
)

RNG = np.random.default_rng(9)


def _batch(b=8, n=64, l=6, k=3, rng=RNG):
    w = rng.random((b, n, k))
    h = rng.random((b, k, l))
    return np.maximum(w @ h + 0.01 * rng.random((b, n, l)), 0)


@pytest.fixture(scope="module")
def mesh_2x4():
    return make_mesh((2, 4))


@pytest.fixture(scope="module")
def mesh_8x1():
    return make_mesh((8, 1))


class TestBatchedNMF:
    def test_fit_mu_batch_matches_sequential(self):
        xs = _batch(b=4)
        w0, h0 = init_batch(xs, 3, init="nndsvda")
        batched = fit_mu_batch(xs, w0, h0, max_iter=500, tol=1e-8)
        for b in range(4):
            single = fit_mu(xs[b], w0[b], h0[b], max_iter=500, tol=1e-8)
            np.testing.assert_allclose(
                np.asarray(batched.w[b]), np.asarray(single.w), rtol=1e-10
            )
            assert int(batched.n_iter[b]) == int(single.n_iter)

    def test_fit_cd_batch_runs(self):
        xs = _batch(b=4)
        w0, h0 = init_batch(xs, 3, init="nndsvda")
        state = fit_cd_batch(xs, w0, h0, max_iter=300, tol=1e-8)
        overall, per = vaf_batch(
            xs, state.w, jnp.swapaxes(state.ht, -1, -2)
        )
        assert np.all(np.asarray(overall) > 0.99)
        assert per.shape == (4, 6)

    def test_pad_and_stack_masks(self):
        trials = [RNG.random((50, 4)), RNG.random((30, 4))]
        batch, mask = pad_and_stack(trials)
        assert batch.shape == (2, 50, 4)
        assert mask[1, 29] == 1.0 and mask[1, 30] == 0.0
        np.testing.assert_array_equal(batch[1, 30:], 0)

    def test_padded_trial_matches_unpadded(self):
        # zero-padding + zeroed W rows must give the exact same factors
        x_short = np.maximum(RNG.random((40, 6)), 0)
        batch, mask = pad_and_stack([x_short], pad_to=64)
        w0, h0 = init_batch(jnp.asarray(batch), 3, init="nndsvda",
                            mask=jnp.asarray(mask))
        # NOTE: init differs between padded/unpadded (SVD of padded x),
        # so compare through a shared custom init instead.
        w0u, h0u = initialize_nmf(x_short, 3, init="nndsvda")
        w0p = np.zeros((64, 3)); w0p[:40] = np.asarray(w0u)
        padded = fit_mu(batch[0], w0p, np.asarray(h0u), max_iter=300, tol=1e-8)
        plain = fit_mu(x_short, np.asarray(w0u), np.asarray(h0u),
                       max_iter=300, tol=1e-8)
        np.testing.assert_allclose(
            np.asarray(padded.w[:40]), np.asarray(plain.w), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(padded.h), np.asarray(plain.h), rtol=1e-12
        )
        np.testing.assert_array_equal(np.asarray(padded.w[40:]), 0)

    def test_rank_sweep_matches_individual_fits(self):
        x = _batch(b=1)[0]
        ranks = [1, 2, 3, 4]
        states, vafs = rank_sweep_batch(
            x, ranks, init="nndsvda", solver="mu", max_iter=300, tol=1e-8
        )
        for i, k in enumerate(ranks):
            w0, h0 = initialize_nmf(x, k, init="nndsvda")
            single = fit_mu(x, w0, h0, max_iter=300, tol=1e-8)
            np.testing.assert_allclose(
                np.asarray(states.w[i][:, :k]), np.asarray(single.w),
                rtol=1e-10,
            )
            # padded components stay exactly zero
            np.testing.assert_array_equal(np.asarray(states.w[i][:, k:]), 0)
        # VAF should broadly improve with rank; tiny decreases are
        # legitimate (NMF converges to local optima under tol stopping)
        vafs_np = np.asarray(vafs)
        assert np.all(np.diff(vafs_np) >= -1e-3)
        assert vafs_np[-1] > vafs_np[0]


class TestShardedNMF:
    def test_sharded_step_matches_local(self, mesh_2x4):
        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        from muscle_synergies_tpu.models.mu import mu_update, frobenius_error

        w_s, h_s, err_s = sharded_mu_step(
            jnp.asarray(xs), w0, h0, mesh_2x4
        )
        for b in range(8):
            w_ref, h_ref = mu_update(xs[b], w0[b], h0[b])
            np.testing.assert_allclose(np.asarray(w_s[b]), np.asarray(w_ref),
                                       rtol=1e-10)
            np.testing.assert_allclose(np.asarray(h_s[b]), np.asarray(h_ref),
                                       rtol=1e-10)
            np.testing.assert_allclose(
                float(err_s[b]),
                float(frobenius_error(xs[b], w_ref, h_ref)),
                rtol=1e-10,
            )

    def test_sharded_fit_matches_vmapped(self, mesh_2x4):
        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_mu(
            jnp.asarray(xs), w0, h0, mesh_2x4, max_iter=200, tol=1e-6
        )
        local = fit_mu_batch(jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6)
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(sharded.h), np.asarray(local.h), rtol=1e-8
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )

    def test_data_parallel_only_mesh(self, mesh_8x1):
        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        w_s, h_s, err = sharded_mu_step(jnp.asarray(xs), w0, h0, mesh_8x1)
        assert np.all(np.isfinite(np.asarray(err)))


class TestTensorParallelNMF:
    """Channel-axis sharding (the §2.5 tensor-parallelism row)."""

    def test_tp_fit_matches_vmapped(self):
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            MODEL_AXIS,
            make_mesh,
            sharded_fit_mu_tp,
        )

        # 2-way data x 4-way channel shards over a wide (HD-sEMG-like)
        # channel count
        mesh = make_mesh((2, 4), axis_names=(DATA_AXIS, MODEL_AXIS))
        xs = _batch(b=4, n=64, l=32)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        tp = sharded_fit_mu_tp(
            jnp.asarray(xs), w0, h0, mesh, max_iter=200, tol=1e-6
        )
        local = fit_mu_batch(jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6)
        np.testing.assert_allclose(
            np.asarray(tp.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(tp.h), np.asarray(local.h), rtol=1e-8
        )
        np.testing.assert_array_equal(
            np.asarray(tp.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_array_equal(
            np.asarray(tp.converged), np.asarray(local.converged)
        )


class TestShardedFilters:
    def test_sharded_sosfilt_matches_local(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        x = RNG.standard_normal((512, 3))
        y_sharded = np.asarray(sharded_sosfilt(sos, jnp.asarray(x), mesh))
        y_local = np.asarray(sosfilt(sos, x))
        np.testing.assert_allclose(y_sharded, y_local, rtol=1e-9, atol=1e-11)

    def test_sharded_sosfiltfilt_matches_scipy(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        x = RNG.standard_normal((512, 3))
        y_sharded = np.asarray(sharded_sosfiltfilt(sos, jnp.asarray(x), mesh))
        ref = sps.sosfiltfilt(sos, x, axis=0)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_sharded_sosfiltfilt_matches_local_jax(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, [8.0, 16.0], 100.0, band_type="bandpass")
        x = RNG.standard_normal((512, 3))
        y_sharded = np.asarray(sharded_sosfiltfilt(sos, jnp.asarray(x), mesh))
        y_local = np.asarray(sosfiltfilt(sos, x))
        scale = np.max(np.abs(y_local))
        np.testing.assert_allclose(
            y_sharded, y_local, rtol=1e-7, atol=1e-8 * scale
        )

    @pytest.mark.parametrize("n", [510, 509, 505])
    def test_uneven_split_still_exact(self, n):
        """Indivisible lengths shard via the reflection-pad extension."""
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        x = RNG.standard_normal((n, 3))
        y_sharded = np.asarray(sharded_sosfiltfilt(sos, jnp.asarray(x), mesh))
        ref = sps.sosfiltfilt(sos, x, axis=0)
        scale = np.max(np.abs(ref))
        assert y_sharded.shape == ref.shape
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_padlen_exceeding_block_still_exact(self):
        """The pad no longer constrains the per-device block length."""
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)  # default padlen 15 > 64/8
        x = RNG.standard_normal((64, 3))
        y_sharded = np.asarray(sharded_sosfiltfilt(sos, jnp.asarray(x), mesh))
        ref = sps.sosfiltfilt(sos, x, axis=0)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_single_sample_blocks_still_exact(self):
        """N barely above the device count: 1-sample blocks, exact."""
        mesh = make_mesh((1, 8))
        sos = sos_design(2, 10.0, 100.0)
        x = RNG.standard_normal((7, 2))
        y_sharded = np.asarray(
            sharded_sosfiltfilt(sos, jnp.asarray(x), mesh, padlen=5)
        )
        ref = sps.sosfiltfilt(sos, x, axis=0, padlen=5)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_tiny_signal_falls_back_locally(self):
        """Gap beyond the reflection: the gather fallback matches scipy."""
        mesh = make_mesh((1, 8))
        sos = sos_design(1, 10.0, 100.0)
        x = RNG.standard_normal((3, 2))
        y_sharded = np.asarray(
            sharded_sosfiltfilt(sos, jnp.asarray(x), mesh, padlen=2)
        )
        ref = sps.sosfiltfilt(sos, x, axis=0, padlen=2)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_padlen_at_least_signal_still_raises(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        with pytest.raises(ValueError, match="padlen"):
            sharded_sosfiltfilt(sos, jnp.ones((12, 3)), mesh)

    @pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
    @pytest.mark.parametrize("n", [512, 509])
    def test_padtype_surface_matches_scipy(self, padtype, n):
        """Every local-API padtype works sharded, even/uneven lengths.

        (VERDICT r3 item 6: sharded_sosfiltfilt previously supported
        only padtype='odd' while the local API takes all four.)
        """
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        x = RNG.standard_normal((n, 3))
        y_sharded = np.asarray(
            sharded_sosfiltfilt(sos, jnp.asarray(x), mesh, padtype=padtype)
        )
        ref = sps.sosfiltfilt(sos, x, axis=0, padtype=padtype)
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(y_sharded, ref, rtol=1e-7, atol=1e-8 * scale)

    def test_invalid_padtype_rejected(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        with pytest.raises(ValueError, match="padtype"):
            sharded_sosfiltfilt(
                sos, jnp.ones((64, 3)), mesh, padtype="bogus"
            )

    def test_sosfilt_uneven_split_exact(self):
        mesh = make_mesh((1, 8))
        sos = sos_design(4, 10.0, 100.0)
        x = RNG.standard_normal((509, 3))
        y_sharded = np.asarray(sharded_sosfilt(sos, jnp.asarray(x), mesh))
        y_local = np.asarray(sosfilt(sos, x))
        assert y_sharded.shape == y_local.shape
        np.testing.assert_allclose(y_sharded, y_local, rtol=1e-9, atol=1e-11)


class TestShardedCD:
    def test_sharded_cd_matches_vmapped(self, mesh_2x4):
        from muscle_synergies_tpu.parallel import sharded_fit_cd

        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_cd(
            jnp.asarray(xs), w0, h0, mesh_2x4, max_iter=200, tol=1e-6
        )
        local = fit_cd_batch(jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6)
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-7, atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(sharded.ht), np.asarray(local.ht), rtol=1e-7,
            atol=1e-10,
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )


class TestMeshConstruction:
    """make_mesh ergonomics + the multi-host entry point."""

    def test_infer_data_axis(self):
        mesh = make_mesh((-1, 2))
        assert mesh.shape == {"data": 4, "time": 2}

    def test_infer_time_axis(self):
        mesh = make_mesh((4, -1))
        assert mesh.shape == {"data": 4, "time": 2}

    def test_both_inferred_rejected(self):
        with pytest.raises(ValueError, match="at most one"):
            make_mesh((-1, -1))

    def test_non_dividing_inference_rejected(self):
        with pytest.raises(ValueError, match="split evenly"):
            make_mesh((-1, 3))

    def test_mismatch_error_mentions_provisioning(self):
        with pytest.raises(ValueError, match="host_platform_device_count"):
            make_mesh((4, 3))

    def test_init_distributed_single_process_noop(self, monkeypatch):
        from muscle_synergies_tpu.parallel import init_distributed

        for var in (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
        ):
            monkeypatch.delenv(var, raising=False)
        # degenerate single-process path: must not try to reach a
        # coordinator, must report one process
        assert init_distributed(num_processes=1) == 1
        assert init_distributed() == jax.process_count()


def test_init_distributed_idempotent_after_real_init():
    """Second and argless calls after a real initialize are no-ops.

    jax 0.9 raises RuntimeError("distributed.initialize should only be
    called once.") on a second call — the wrapper must swallow exactly
    that and report the process count.  Runs in a subprocess because
    the distributed runtime cannot be torn down cleanly in-process.
    """
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    code = f"""
import jax
from muscle_synergies_tpu.parallel import init_distributed
addr = "127.0.0.1:{port}"
n1 = init_distributed(addr, num_processes=1, process_id=0)
n2 = init_distributed(addr, num_processes=1, process_id=0)
n3 = init_distributed()
assert n1 == n2 == n3 == 1, (n1, n2, n3)
assert jax.distributed.is_initialized()
print("IDEMPOTENT_OK")
"""
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the subprocess sees only the repository on its path (same as
    # tests/test_distributed_2proc.py)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    result = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=180,
        env=env,
        cwd=repo,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert "IDEMPOTENT_OK" in result.stdout


def test_sharded_fit_kl_matches_local_batch(mesh_2x4):
    """DP+SP KL fit equals the local batched beta solver exactly."""
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch
    from muscle_synergies_tpu.parallel import sharded_fit_kl
    from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS

    rng = np.random.default_rng(77)
    b, n, l, k = 8, 16, 6, 3
    xs = jnp.asarray(rng.random((b, n, l)) + 0.01)
    w0 = jnp.asarray(np.abs(rng.standard_normal((b, n, k))))
    h0 = jnp.asarray(np.abs(rng.standard_normal((b, k, l))))

    from jax.sharding import NamedSharding, PartitionSpec as P

    xs_s = jax.device_put(xs, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    w_s = jax.device_put(w0, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    h_s = jax.device_put(h0, NamedSharding(mesh_2x4, P(DATA_AXIS)))

    got = sharded_fit_kl(xs_s, w_s, h_s, mesh_2x4, max_iter=120, tol=1e-5)
    ref = fit_mu_beta_batch(xs, w0, h0, beta=1.0, max_iter=120, tol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.previous_error),
                               np.asarray(ref.previous_error), rtol=1e-9)


def test_sharded_tol_zero_runs_max_iter(mesh_2x4):
    """tol=0 disables the sharded criterion, like the local solvers."""
    from muscle_synergies_tpu.parallel import sharded_fit_kl, sharded_fit_mu
    from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(41)
    b, n, l, k = 8, 16, 6, 3
    # perfectly factorizable data converges almost immediately, the
    # regime where a ULP uptick could fake convergence under tol=0
    wt = rng.random((b, n, k)); ht = rng.random((k, l))
    xs = jnp.asarray(wt @ ht)
    w0 = jnp.asarray(np.abs(rng.standard_normal((b, n, k))))
    h0 = jnp.asarray(np.abs(rng.standard_normal((b, k, l))))
    xs_s = jax.device_put(xs, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    w_s = jax.device_put(w0, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    h_s = jax.device_put(h0, NamedSharding(mesh_2x4, P(DATA_AXIS)))

    for fit in (sharded_fit_mu, sharded_fit_kl):
        state = fit(xs_s, w_s, h_s, mesh_2x4, max_iter=60, tol=0.0)
        assert np.all(np.asarray(state.n_iter) == 60), fit.__name__
        assert not np.any(np.asarray(state.converged)), fit.__name__


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5, 2.0, 2.5])
def test_sharded_fit_beta_matches_local_batch(mesh_2x4, beta):
    """DP+SP generic-beta fit equals the local batched solver exactly.

    Covers Itakura-Saito (beta=0) and fractional betas — every loss
    the local solvers offer also runs sharded (SURVEY §2.5 DP row).
    """
    from muscle_synergies_tpu.models.batch import fit_mu_beta_batch
    from muscle_synergies_tpu.parallel import sharded_fit_beta
    from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(78)
    b, n, l, k = 8, 16, 6, 3
    xs = jnp.asarray(rng.random((b, n, l)) + 0.01)  # positive for beta<=0
    w0 = jnp.asarray(np.abs(rng.standard_normal((b, n, k))))
    h0 = jnp.asarray(np.abs(rng.standard_normal((b, k, l))))

    xs_s = jax.device_put(xs, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    w_s = jax.device_put(w0, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS)))
    h_s = jax.device_put(h0, NamedSharding(mesh_2x4, P(DATA_AXIS)))

    got = sharded_fit_beta(xs_s, w_s, h_s, mesh_2x4, beta=beta,
                           max_iter=120, tol=1e-5)
    ref = fit_mu_beta_batch(xs, w0, h0, beta=beta, max_iter=120, tol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.n_iter),
                                  np.asarray(ref.n_iter))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got.previous_error),
                               np.asarray(ref.previous_error), rtol=1e-8)


def test_analyze_dataset_meshes_fractional_beta(mesh_2x4):
    """A meshed analyze_dataset now shards any beta_loss (no fallback)."""
    import warnings

    from muscle_synergies_tpu import analyze_dataset

    rng = np.random.default_rng(12)
    trials = [rng.random((64, 6)) + 0.05 for _ in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the old KL-only fallback warned
        res = analyze_dataset(
            trials, 200.0, ranks=(2, 3), solver="mu", beta_loss=1.5,
            mesh=mesh_2x4, max_iter=60, tol=1e-4,
        )
    assert res.vaf_overall.shape == (2, 4)


class TestShardedMovingRMS:
    def test_matches_local_even_length(self):
        from muscle_synergies_tpu.ops.emg import moving_rms
        from muscle_synergies_tpu.parallel import sharded_moving_rms

        mesh = make_mesh((1, 8))
        x = RNG.standard_normal((512, 3))
        for window in (7, 8, 100, 101):
            y_sharded = np.asarray(
                sharded_moving_rms(jnp.asarray(x), window, mesh)
            )
            y_local = np.asarray(moving_rms(x, window))
            np.testing.assert_allclose(
                y_sharded, y_local, rtol=1e-12, atol=1e-14
            )

    @pytest.mark.parametrize("n", [509, 505, 63])
    def test_uneven_split_exact(self, n):
        from muscle_synergies_tpu.ops.emg import moving_rms
        from muscle_synergies_tpu.parallel import sharded_moving_rms

        mesh = make_mesh((1, 8))
        x = RNG.standard_normal((n, 2))
        y_sharded = np.asarray(sharded_moving_rms(jnp.asarray(x), 10, mesh))
        y_local = np.asarray(moving_rms(x, 10))
        assert y_sharded.shape == y_local.shape
        np.testing.assert_allclose(y_sharded, y_local, rtol=1e-12, atol=1e-14)

    def test_halo_exceeding_block_falls_back(self):
        """Window halo > one block: gather fallback, still exact."""
        from muscle_synergies_tpu.ops.emg import moving_rms
        from muscle_synergies_tpu.parallel import sharded_moving_rms

        mesh = make_mesh((1, 8))
        x = RNG.standard_normal((40, 2))  # blocks of 5, window 31
        y_sharded = np.asarray(sharded_moving_rms(jnp.asarray(x), 31, mesh))
        y_local = np.asarray(moving_rms(x, 31))
        np.testing.assert_allclose(y_sharded, y_local, rtol=1e-12, atol=1e-14)

    def test_window_longer_than_signal_raises(self):
        from muscle_synergies_tpu.parallel import sharded_moving_rms

        mesh = make_mesh((1, 8))
        with pytest.raises(ValueError, match="longer than the signal"):
            sharded_moving_rms(jnp.ones((16, 2)), 17, mesh)
        with pytest.raises(ValueError, match="at least one sample"):
            sharded_moving_rms(jnp.ones((16, 2)), 0, mesh)


class TestShardedPreprocessing:
    """preprocess_trials(mesh=...) routes the time-axis stages through
    the sequence-parallel kernels (VERDICT r3 item 6: the sharded
    filters now have a production consumer)."""

    def _trials(self, lengths, l=4, seed=3):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((n, l)) for n in lengths]

    def test_rms_pipeline_matches_local(self, mesh_2x4):
        from muscle_synergies_tpu.dataset import preprocess_trials
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(use_rms=True, rms_window_s=0.1, reduce_to=32)
        trials = self._trials([256, 256, 256, 256])
        local = np.asarray(preprocess_trials(trials, 200.0, cfg))
        meshed = np.asarray(
            preprocess_trials(trials, 200.0, cfg, mesh=mesh_2x4)
        )
        np.testing.assert_allclose(meshed, local, rtol=1e-12, atol=1e-14)

    def test_rms_pipeline_ragged_matches_local(self, mesh_2x4):
        from muscle_synergies_tpu.dataset import preprocess_trials
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(use_rms=True, rms_window_s=0.1, reduce_to=32)
        trials = self._trials([256, 200, 160, 256])
        local = np.asarray(preprocess_trials(trials, 200.0, cfg))
        meshed = np.asarray(
            preprocess_trials(trials, 200.0, cfg, mesh=mesh_2x4)
        )
        np.testing.assert_allclose(meshed, local, rtol=1e-11, atol=1e-13)

    def test_envelope_pipeline_matches_local(self, mesh_2x4):
        from muscle_synergies_tpu.dataset import preprocess_trials
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(reduce_to=32)  # filtered envelope path
        trials = self._trials([256, 256, 256, 256])
        local = np.asarray(preprocess_trials(trials, 200.0, cfg))
        meshed = np.asarray(
            preprocess_trials(trials, 200.0, cfg, mesh=mesh_2x4)
        )
        np.testing.assert_allclose(meshed, local, rtol=1e-9, atol=1e-11)

    def test_envelope_pipeline_ragged_matches_local(self, mesh_2x4):
        from muscle_synergies_tpu.dataset import preprocess_trials
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(reduce_to=32)
        trials = self._trials([256, 200, 256, 120])
        local = np.asarray(preprocess_trials(trials, 200.0, cfg))
        meshed = np.asarray(
            preprocess_trials(trials, 200.0, cfg, mesh=mesh_2x4)
        )
        np.testing.assert_allclose(meshed, local, rtol=1e-9, atol=1e-11)

    def test_data_only_mesh_uses_local_path(self, mesh_8x1):
        """A mesh without time sharding preprocesses exactly locally."""
        from muscle_synergies_tpu.dataset import preprocess_trials
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(use_rms=True, rms_window_s=0.1, reduce_to=32)
        trials = self._trials([128, 128])
        local = np.asarray(preprocess_trials(trials, 200.0, cfg))
        meshed = np.asarray(
            preprocess_trials(trials, 200.0, cfg, mesh=mesh_8x1)
        )
        np.testing.assert_array_equal(meshed, local)

    def test_meshed_analyze_dataset_end_to_end(self, mesh_2x4):
        """Meshed analyze_dataset: sharded preprocessing + sharded solve
        reproduce the local run (n_iter exactly, factors closely)."""
        from muscle_synergies_tpu import analyze_dataset
        from muscle_synergies_tpu.utils.config import PipelineConfig

        cfg = PipelineConfig(use_rms=True, rms_window_s=0.1, reduce_to=32)
        trials = self._trials([256, 256, 256, 256], l=6)
        kw = dict(
            ranks=(2, 3), config=cfg, solver="mu", max_iter=80, tol=1e-5
        )
        local = analyze_dataset(trials, 200.0, **kw)
        meshed = analyze_dataset(trials, 200.0, mesh=mesh_2x4, **kw)
        np.testing.assert_array_equal(meshed.n_iter, local.n_iter)
        np.testing.assert_allclose(
            meshed.vaf_overall, local.vaf_overall, rtol=1e-9
        )
        np.testing.assert_allclose(meshed.h, local.h, rtol=1e-7, atol=1e-10)


class TestShardedRegularization:
    """The sharded solvers honor the same pre-scaled L1/L2 penalties
    (and the accelerated-MU ``inner_iter``) as their local
    counterparts — the sparsity surface is uniform across every
    execution path (loop, batched, Pallas-rejected, mesh-sharded)."""

    REGS = dict(l1_reg_w=0.7, l2_reg_w=1.3, l1_reg_h=0.4, l2_reg_h=2.1)

    def test_sharded_mu_penalties_match_vmapped(self, mesh_2x4):
        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_mu(
            jnp.asarray(xs), w0, h0, mesh_2x4, max_iter=200, tol=1e-6,
            **self.REGS,
        )
        local = fit_mu_batch(
            jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6, **self.REGS
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(sharded.h), np.asarray(local.h), rtol=1e-8
        )

    def test_sharded_mu_inner_iter_matches_vmapped(self, mesh_2x4):
        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_mu(
            jnp.asarray(xs), w0, h0, mesh_2x4, max_iter=200, tol=1e-6,
            inner_iter=3,
        )
        local = fit_mu_batch(
            jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6, inner_iter=3
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(sharded.h), np.asarray(local.h), rtol=1e-8
        )

    def test_sharded_cd_penalties_match_vmapped(self, mesh_2x4):
        from muscle_synergies_tpu.parallel import sharded_fit_cd

        xs = _batch(b=8, n=64)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_cd(
            jnp.asarray(xs), w0, h0, mesh_2x4, max_iter=200, tol=1e-6,
            **self.REGS,
        )
        local = fit_cd_batch(
            jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6, **self.REGS
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-7,
            atol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(sharded.ht), np.asarray(local.ht), rtol=1e-7,
            atol=1e-10,
        )

    @pytest.mark.parametrize("beta", [1.0, 1.5])
    def test_sharded_beta_penalties_match_vmapped(self, mesh_2x4, beta):
        from muscle_synergies_tpu.models.batch import fit_mu_beta_batch
        from muscle_synergies_tpu.parallel import sharded_fit_beta

        xs = _batch(b=8, n=64) + 0.05  # strictly positive
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        sharded = sharded_fit_beta(
            jnp.asarray(xs), w0, h0, mesh_2x4, beta=beta, max_iter=100,
            tol=1e-5, **self.REGS,
        )
        local = fit_mu_beta_batch(
            jnp.asarray(xs), w0, h0, beta=beta, max_iter=100, tol=1e-5,
            **self.REGS,
        )
        np.testing.assert_array_equal(
            np.asarray(sharded.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_allclose(
            np.asarray(sharded.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(sharded.h), np.asarray(local.h), rtol=1e-8
        )

    def test_tp_penalties_and_inner_iter_match_vmapped(self):
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            MODEL_AXIS,
            make_mesh,
            sharded_fit_mu_tp,
        )

        mesh = make_mesh((2, 4), axis_names=(DATA_AXIS, MODEL_AXIS))
        xs = _batch(b=4, n=64, l=32)
        w0, h0 = init_batch(jnp.asarray(xs), 3, init="nndsvda")
        tp = sharded_fit_mu_tp(
            jnp.asarray(xs), w0, h0, mesh, max_iter=200, tol=1e-6,
            inner_iter=2, **self.REGS,
        )
        local = fit_mu_batch(
            jnp.asarray(xs), w0, h0, max_iter=200, tol=1e-6, inner_iter=2,
            **self.REGS,
        )
        np.testing.assert_array_equal(
            np.asarray(tp.n_iter), np.asarray(local.n_iter)
        )
        np.testing.assert_allclose(
            np.asarray(tp.w), np.asarray(local.w), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(tp.h), np.asarray(local.h), rtol=1e-8
        )

    def test_meshed_analyze_dataset_alpha_matches_local(self, mesh_2x4):
        """analyze_dataset(alpha_W=...) gives the same sparse solve
        meshed and unmeshed (rank-padded entries stay exactly zero)."""
        from muscle_synergies_tpu import analyze_dataset
        from muscle_synergies_tpu.utils.config import PipelineConfig

        rng = np.random.default_rng(7)
        trials = [rng.standard_normal((256, 6)) for _ in range(4)]
        cfg = PipelineConfig(use_rms=True, rms_window_s=0.1, reduce_to=32)
        kw = dict(
            ranks=(2, 3), config=cfg, solver="mu", max_iter=80, tol=1e-5,
            alpha_W=0.05, l1_ratio=0.5,
        )
        local = analyze_dataset(trials, 200.0, **kw)
        meshed = analyze_dataset(trials, 200.0, mesh=mesh_2x4, **kw)
        np.testing.assert_array_equal(meshed.n_iter, local.n_iter)
        np.testing.assert_allclose(
            meshed.vaf_overall, local.vaf_overall, rtol=1e-9
        )
        np.testing.assert_allclose(meshed.h, local.h, rtol=1e-7, atol=1e-10)
        # rank-2 grid entries keep their padded third component at zero
        np.testing.assert_array_equal(meshed.h[0][:, 2:, :], 0)


class TestShardedCNMF:
    """Sequence-parallel convolutive NMF: halo-exchange exactness."""

    def _problem(self, b=8, t=48, l=6, k=2, d=5, seed=21):
        from muscle_synergies_tpu.models.cnmf import init_cnmf

        rng = np.random.default_rng(seed)
        xs = np.asarray(rng.random((b, t, l)) + 0.01)
        c0, s0 = init_cnmf(xs, k, d, seed=seed + 1)
        return xs, c0, s0

    def test_matches_batched_local(self, mesh_2x4):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch
        from muscle_synergies_tpu.parallel import sharded_fit_cnmf
        from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS

        xs, c0, s0 = self._problem()
        ref = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
            max_iter=120, tol=1e-5,
        )
        xs_s = jax.device_put(
            xs, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS))
        )
        c_s = jax.device_put(
            c0, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS))
        )
        s_s = jax.device_put(s0, NamedSharding(mesh_2x4, P(DATA_AXIS)))
        got = sharded_fit_cnmf(xs_s, c_s, s_s, mesh_2x4,
                               max_iter=120, tol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.n_iter),
                                      np.asarray(ref.n_iter))
        np.testing.assert_array_equal(np.asarray(got.converged),
                                      np.asarray(ref.converged))
        np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.previous_error),
                                   np.asarray(ref.previous_error),
                                   rtol=1e-9)

    def test_single_lag_degenerates_cleanly(self, mesh_2x4):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch
        from muscle_synergies_tpu.parallel import sharded_fit_cnmf
        from muscle_synergies_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS

        xs, c0, s0 = self._problem(d=1)
        ref = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
            max_iter=60, tol=1e-5,
        )
        xs_s = jax.device_put(
            xs, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS))
        )
        c_s = jax.device_put(
            c0, NamedSharding(mesh_2x4, P(DATA_AXIS, TIME_AXIS))
        )
        s_s = jax.device_put(s0, NamedSharding(mesh_2x4, P(DATA_AXIS)))
        got = sharded_fit_cnmf(xs_s, c_s, s_s, mesh_2x4,
                               max_iter=60, tol=1e-5)
        np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s),
                                   rtol=1e-9, atol=1e-12)

    def test_halo_and_divisibility_guards(self, mesh_2x4):
        from muscle_synergies_tpu.parallel import sharded_fit_cnmf

        xs, c0, s0 = self._problem(t=48, d=14)  # halo 13 > 12-row shard
        with pytest.raises(ValueError, match="halo"):
            sharded_fit_cnmf(xs, c0, s0, mesh_2x4)
        xs, c0, s0 = self._problem(t=50, d=3)
        with pytest.raises(ValueError, match="divide"):
            sharded_fit_cnmf(xs, c0, s0, mesh_2x4)

    def test_tp_fit_matches_batched_local(self):
        """Channel-sharded convolutive fit equals the local batch.

        The tensor-parallel counterpart: a wide (HD-sEMG-like) channel
        count splits 4-way over the model axis; the C update's channel
        psum is the only cross-shard communication.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from muscle_synergies_tpu.models.cnmf import fit_cnmf_batch
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            MODEL_AXIS,
            make_mesh,
            sharded_fit_cnmf_tp,
        )

        mesh = make_mesh((2, 4), axis_names=(DATA_AXIS, MODEL_AXIS))
        xs, c0, s0 = self._problem(b=4, t=48, l=32, k=2, d=5)
        ref = fit_cnmf_batch(
            jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
            max_iter=120, tol=1e-5,
        )
        xs_s = jax.device_put(
            xs, NamedSharding(mesh, P(DATA_AXIS, None, MODEL_AXIS))
        )
        c_s = jax.device_put(c0, NamedSharding(mesh, P(DATA_AXIS)))
        s_s = jax.device_put(
            s0, NamedSharding(mesh, P(DATA_AXIS, None, None, MODEL_AXIS))
        )
        got = sharded_fit_cnmf_tp(xs_s, c_s, s_s, mesh,
                                  max_iter=120, tol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.n_iter),
                                      np.asarray(ref.n_iter))
        np.testing.assert_array_equal(np.asarray(got.converged),
                                      np.asarray(ref.converged))
        np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s),
                                   rtol=1e-9, atol=1e-12)

    def test_tp_channel_divisibility_guard(self):
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            MODEL_AXIS,
            make_mesh,
            sharded_fit_cnmf_tp,
        )

        mesh = make_mesh((2, 4), axis_names=(DATA_AXIS, MODEL_AXIS))
        xs, c0, s0 = self._problem(b=4, l=6)  # 6 % 4 != 0
        with pytest.raises(ValueError, match="channel count"):
            sharded_fit_cnmf_tp(xs, c0, s0, mesh)


class TestShardedNM3F:
    """Data-parallel space-by-time factorization: psum'd module sums."""

    def test_matches_local_fit(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from muscle_synergies_tpu.models.nm3f import fit_nm3f, init_nm3f
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            make_mesh,
            sharded_fit_nm3f,
        )

        rng = np.random.default_rng(33)
        xs = rng.uniform(0.1, 1.0, (8, 40, 6))
        w0, a0, s0 = init_nm3f(xs, 3, 2, seed=1)
        ref = fit_nm3f(
            jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
            jnp.asarray(s0), max_iter=200, tol=1e-5,
        )
        mesh = make_mesh((8, 1))
        xs_s = jax.device_put(xs, NamedSharding(mesh, P(DATA_AXIS)))
        a_s = jax.device_put(a0, NamedSharding(mesh, P(DATA_AXIS)))
        got = sharded_fit_nm3f(
            xs_s, jnp.asarray(w0), a_s, jnp.asarray(s0), mesh,
            max_iter=200, tol=1e-5,
        )
        assert int(got.n_iter) == int(ref.n_iter)
        assert bool(got.converged) == bool(ref.converged)
        np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.a), np.asarray(ref.a),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(
            float(got.previous_error), float(ref.previous_error), rtol=1e-9
        )

    def test_trial_divisibility_guard(self):
        from muscle_synergies_tpu.models.nm3f import init_nm3f
        from muscle_synergies_tpu.parallel import make_mesh, sharded_fit_nm3f

        rng = np.random.default_rng(3)
        xs = rng.uniform(0.1, 1.0, (6, 20, 4))  # 6 % 8 != 0
        w0, a0, s0 = init_nm3f(xs, 2, 2)
        with pytest.raises(ValueError, match="trial count"):
            sharded_fit_nm3f(xs, w0, a0, s0, make_mesh((8, 1)))

    def test_sample_divisibility_guard(self):
        from muscle_synergies_tpu.models.nm3f import init_nm3f
        from muscle_synergies_tpu.parallel import make_mesh, sharded_fit_nm3f

        rng = np.random.default_rng(3)
        xs = rng.uniform(0.1, 1.0, (8, 30, 4))  # 30 % 8 != 0
        w0, a0, s0 = init_nm3f(xs, 2, 2)
        with pytest.raises(ValueError, match="sample count"):
            sharded_fit_nm3f(xs, w0, a0, s0, make_mesh((1, 8)))

    @pytest.mark.parametrize("layout", [(2, 4), (1, 8)])
    def test_time_sharded_matches_local_fit(self, layout):
        """Sequence-parallel NM3F: the shared time base shards too."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from muscle_synergies_tpu.models.nm3f import fit_nm3f, init_nm3f
        from muscle_synergies_tpu.parallel import (
            DATA_AXIS,
            TIME_AXIS,
            make_mesh,
            sharded_fit_nm3f,
        )

        rng = np.random.default_rng(34)
        xs = rng.uniform(0.1, 1.0, (4, 40, 6))
        w0, a0, s0 = init_nm3f(xs, 3, 2, seed=2)
        ref = fit_nm3f(
            jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
            jnp.asarray(s0), max_iter=200, tol=1e-5,
        )
        mesh = make_mesh(layout)
        xs_s = jax.device_put(
            xs, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS))
        )
        w_s = jax.device_put(w0, NamedSharding(mesh, P(TIME_AXIS)))
        a_s = jax.device_put(a0, NamedSharding(mesh, P(DATA_AXIS)))
        got = sharded_fit_nm3f(
            xs_s, w_s, a_s, jnp.asarray(s0), mesh,
            max_iter=200, tol=1e-5,
        )
        assert int(got.n_iter) == int(ref.n_iter)
        assert bool(got.converged) == bool(ref.converged)
        np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                                   rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.a), np.asarray(ref.a),
                                   rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s),
                                   rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(
            float(got.previous_error), float(ref.previous_error),
            rtol=1e-9,
        )


class TestMeshedSpaceByTime:
    """find_space_by_time_synergies(mesh=...): sharded restart fits."""

    def test_meshed_matches_local_with_zero_padding(self):
        from muscle_synergies_tpu.models.nm3f import (
            find_space_by_time_synergies,
        )
        from muscle_synergies_tpu.parallel import make_mesh

        rng = np.random.default_rng(44)
        xs = rng.uniform(0.1, 1.0, (6, 40, 5))  # 6 trials pad to 8
        kw = dict(max_iter=200, tol=1e-6, n_inits=3, seed=4)
        ref = find_space_by_time_synergies(xs, 3, 2, **kw)
        got = find_space_by_time_synergies(
            xs, 3, 2, mesh=make_mesh((8, 1)), **kw
        )
        assert got.n_iter == ref.n_iter
        np.testing.assert_allclose(
            got.restart_errors, ref.restart_errors, rtol=1e-9
        )
        np.testing.assert_allclose(
            got.temporal_modules.to_numpy(),
            ref.temporal_modules.to_numpy(), rtol=1e-7, atol=1e-12,
        )
        np.testing.assert_allclose(
            got.spatial_modules.to_numpy(),
            ref.spatial_modules.to_numpy(), rtol=1e-7, atol=1e-12,
        )
        np.testing.assert_allclose(
            got.coefficients, ref.coefficients, rtol=1e-7, atol=1e-12
        )
        assert got.coefficients.shape == (6, 3, 2)

    def test_time_sharded_mesh(self):
        from muscle_synergies_tpu.models.nm3f import (
            find_space_by_time_synergies,
        )
        from muscle_synergies_tpu.parallel import make_mesh

        rng = np.random.default_rng(45)
        xs = rng.uniform(0.1, 1.0, (4, 40, 5))
        kw = dict(max_iter=150, tol=1e-6, n_inits=2, seed=1)
        ref = find_space_by_time_synergies(xs, 2, 2, **kw)
        got = find_space_by_time_synergies(
            xs, 2, 2, mesh=make_mesh((2, 4)), **kw
        )
        assert got.n_iter == ref.n_iter
        np.testing.assert_allclose(
            got.temporal_modules.to_numpy(),
            ref.temporal_modules.to_numpy(), rtol=1e-7, atol=1e-12,
        )

    def test_non_dividing_time_axis_warns_and_falls_back(self):
        from muscle_synergies_tpu.models.nm3f import (
            find_space_by_time_synergies,
        )
        from muscle_synergies_tpu.parallel import make_mesh

        rng = np.random.default_rng(46)
        xs = rng.uniform(0.1, 1.0, (4, 30, 5))  # 30 % 8 != 0
        kw = dict(max_iter=100, tol=1e-6, n_inits=2, seed=2)
        ref = find_space_by_time_synergies(xs, 2, 2, **kw)
        with pytest.warns(UserWarning, match="time axis"):
            got = find_space_by_time_synergies(
                xs, 2, 2, mesh=make_mesh((1, 8)), **kw
            )
        np.testing.assert_allclose(
            got.temporal_modules.to_numpy(),
            ref.temporal_modules.to_numpy(), rtol=1e-12,
        )
