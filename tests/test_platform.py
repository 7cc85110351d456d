"""The one implementation resolver, the compile-cache rule and the
export's default platforms."""

import inspect
import os
import subprocess

import pytest

from muscle_synergies_tpu.utils import platform
from muscle_synergies_tpu.utils.platform import (
    KERNEL_MAX_RANK,
    enable_compile_cache,
    resolve_impl,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_backend(monkeypatch):
    """Pretend the default backend is ``name`` for the resolver."""

    def use(name):
        monkeypatch.setattr(platform.jax, "default_backend", lambda: name)

    return use


@pytest.mark.parametrize("family", ["mu", "cd", "beta", "cnmf", "nm3f"])
def test_auto_is_xla_off_the_gpu(on_backend, family):
    on_backend("cpu")
    assert resolve_impl("auto", family) == "xla"


@pytest.mark.parametrize(
    "family, want",
    [("mu", "pallas"), ("cd", "pallas"), ("beta", "pallas"),
     ("cnmf", "xla"), ("nm3f", "xla")],
)
def test_auto_on_a_gpu_picks_kept_kernels(on_backend, family, want):
    on_backend("gpu")
    assert resolve_impl("auto", family, rank=4) == want


def test_auto_on_a_gpu_bounds_rank_and_penalties(on_backend):
    on_backend("gpu")
    assert resolve_impl("auto", "cd", rank=KERNEL_MAX_RANK) == "pallas"
    assert resolve_impl("auto", "cd", rank=KERNEL_MAX_RANK + 1) == "xla"
    assert resolve_impl("auto", "mu", rank=4, penalized=True) == "xla"
    # an explicit request is honoured at any rank
    assert resolve_impl("pallas", "mu", rank=10) == "pallas"


def test_pallas_raises_without_a_gpu(on_backend):
    on_backend("cpu")
    with pytest.raises(RuntimeError, match="need a GPU"):
        resolve_impl("pallas", "mu")
    # interpret mode is reachable only by asking for it
    assert resolve_impl("pallas", "mu", interpret=True) == "pallas"


def test_pallas_raises_for_families_without_kernels(on_backend):
    on_backend("gpu")
    for family in ("cnmf", "nm3f"):
        with pytest.raises(ValueError, match="no Pallas kernel"):
            resolve_impl("pallas", family)
    with pytest.raises(ValueError, match="L1/L2"):
        resolve_impl("pallas", "cd", penalized=True)
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("cuda", "mu")


def test_batch_solvers_raise_for_pallas_on_cpu():
    import numpy as np

    from muscle_synergies_tpu.models.batch import fit_cd_batch, fit_mu_batch

    xs = np.ones((2, 8, 3))
    w = np.ones((2, 8, 2))
    h = np.ones((2, 2, 3))
    for fit in (fit_mu_batch, fit_cd_batch):
        with pytest.raises(RuntimeError, match="GPU"):
            fit(xs, w, h, impl="pallas")


def test_compile_cache_honours_the_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(
        platform.jax.config, "update", lambda *a: calls.append(a)
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert enable_compile_cache() == "/some/where"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_a_fixed_ignored_path(monkeypatch):
    calls = []
    monkeypatch.setattr(
        platform.jax.config, "update", lambda *a: calls.append(a)
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert enable_compile_cache() == path  # the same path every call
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", ".jax_cache"], cwd=REPO
    )
    assert ignored.returncode == 0


def test_export_lowers_for_cpu_and_cuda_by_default():
    from muscle_synergies_tpu.__main__ import _build_parser
    from muscle_synergies_tpu.models.export import export_transform

    default = inspect.signature(export_transform).parameters["platforms"]
    assert default.default == ("cpu", "cuda")
    args = _build_parser().parse_args(
        ["export-transform", "m.npz", "--shape", "200,8", "-o", "t.hlo"]
    )
    assert args.platforms == "cpu,cuda"


def test_exported_artifact_carries_cuda(tmp_path):
    import numpy as np

    from muscle_synergies_tpu.models import NMFModel
    from muscle_synergies_tpu.models.export import (
        export_transform,
        load_transform,
    )

    x = np.abs(np.random.default_rng(0).normal(size=(40, 6)))
    model = NMFModel(n_components=2, max_iter=100).fit(x)
    fn = load_transform(export_transform(model, ("b", 40, 6)))
    assert fn.exported.platforms == ("cpu", "cuda")
    assert fn(x[None].repeat(3, 0).astype("float32")).shape == (3, 40, 2)

