"""StableHLO transform export (`models/export.py`).

Pins the serving contract: a fitted estimator's transform, serialized
through ``jax.export``, replays from bytes (or a file) with no package
code in the loop — exactly equal to a jitted call of the live model,
and equal to the eager ``transform`` up to jit fusion reordering.
Tests run in float64 on the CPU mesh (conftest enables x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas
import pytest

from muscle_synergies_tpu.models import (
    CNMFModel,
    NM3FModel,
    NMFModel,
    export_transform,
    load_transform,
)

RNG = np.random.default_rng(11)


def _emg_df(n=40, l=5):
    w = RNG.uniform(0.1, 1.0, size=(n, 3))
    h = RNG.uniform(0.1, 1.0, size=(3, l))
    return pandas.DataFrame(w @ h, columns=[f"m{i}" for i in range(l)])


class TestNMFExport:
    def test_matches_jitted_model_exactly(self):
        x = _emg_df()
        model = NMFModel(n_components=2, random_state=0, max_iter=300).fit(x)
        fn = load_transform(
            export_transform(model, x.shape, dtype=jnp.float64)
        )
        jitted = jax.jit(lambda a: model._transform_jax(a)[0])
        np.testing.assert_array_equal(
            fn(x.to_numpy()), np.asarray(jitted(x.to_numpy()))
        )

    def test_close_to_eager_transform(self):
        x = _emg_df()
        model = NMFModel(n_components=2, random_state=0, max_iter=300).fit(x)
        fn = load_transform(
            export_transform(model, x.shape, dtype=jnp.float64)
        )
        # eager vs jit may reorder float ops; f64 keeps it tiny
        np.testing.assert_allclose(
            fn(x.to_numpy()), model.transform(x), rtol=1e-10, atol=1e-12
        )

    def test_mu_solver_exports(self):
        x = _emg_df()
        model = NMFModel(
            n_components=2, solver="mu", beta_loss="kullback-leibler",
            random_state=1, max_iter=150,
        ).fit(x)
        fn = load_transform(
            export_transform(model, x.shape, dtype=jnp.float64)
        )
        np.testing.assert_allclose(
            fn(x.to_numpy()), model.transform(x), rtol=1e-10, atol=1e-12
        )

    def test_file_round_trip(self, tmp_path):
        x = _emg_df()
        model = NMFModel(n_components=2, random_state=0, max_iter=200).fit(x)
        p = tmp_path / "transform.hlo"
        blob = export_transform(model, x.shape, dtype=jnp.float64, path=p)
        assert p.read_bytes() == blob
        fn = load_transform(p)
        assert fn.exported.platforms == ("cpu", "cuda")
        np.testing.assert_allclose(
            fn(x.to_numpy()), model.transform(x), rtol=1e-10, atol=1e-12
        )

    def test_unfitted_raises(self):
        with pytest.raises(ValueError, match="not fitted"):
            export_transform(NMFModel(n_components=2), (40, 5))

    def test_wrong_type_raises(self):
        with pytest.raises(TypeError, match="cannot export"):
            export_transform(object(), (4, 4))


class TestCNMFExport:
    def test_round_trip(self):
        x = RNG.uniform(0.1, 1.0, size=(30, 4))
        model = CNMFModel(2, 3, max_iter=20, n_inits=2, impl="xla").fit(x)
        fn = load_transform(
            export_transform(model, x.shape, dtype=jnp.float64)
        )
        np.testing.assert_allclose(
            fn(x), model.transform(x), rtol=1e-10, atol=1e-12
        )


class TestNM3FExport:
    def test_symbolic_batch_serves_any_size(self):
        xs = RNG.uniform(0.1, 1.0, size=(3, 16, 4))
        model = NM3FModel(2, 2, max_iter=20, n_inits=2).fit(xs)
        fn = load_transform(
            export_transform(model, ("b", 16, 4), dtype=jnp.float64)
        )
        for b in (1, 2, 5):
            xb = RNG.uniform(0.1, 1.0, size=(b, 16, 4))
            out = fn(xb)
            assert out.shape == (b, 2, 2)
            np.testing.assert_allclose(
                out, model.transform(xb), rtol=1e-10, atol=1e-12
            )

    def test_fixed_shape_rejects_other_batch(self):
        xs = RNG.uniform(0.1, 1.0, size=(2, 16, 4))
        model = NM3FModel(2, 2, max_iter=10, n_inits=1).fit(xs)
        fn = load_transform(
            export_transform(model, (2, 16, 4), dtype=jnp.float64)
        )
        bad = RNG.uniform(0.1, 1.0, size=(3, 16, 4))
        with pytest.raises(Exception):
            fn(bad)


class TestBatchedNMFExport:
    def test_three_d_signature_vmaps_trials(self):
        x = _emg_df()
        model = NMFModel(n_components=2, random_state=0, max_iter=200).fit(x)
        fn = load_transform(
            export_transform(model, ("b", 40, 5), dtype=jnp.float64)
        )
        stack = np.stack([x.to_numpy(), x.to_numpy() * 1.5])
        out = fn(stack)
        assert out.shape == (2, 40, 2)
        # each batch entry equals the single-trial artifact's output
        single = load_transform(
            export_transform(model, (40, 5), dtype=jnp.float64)
        )
        for b in range(2):
            np.testing.assert_allclose(
                out[b], single(stack[b]), rtol=1e-10, atol=1e-12
            )
