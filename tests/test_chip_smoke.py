"""``chip_smoke.py``: each phase at a tiny size on the CPU, and its
refusals (no GPU, no package beside it, no pandas on the array path).

The phases run here on the CPU with the Triton kernels in Pallas'
interpreter; the chip run compiles them for the card.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = dataclasses.replace(
    cs.FULL, n_files=2, state_len=60, n_markers=4, ranks=(1, 2, 3),
    max_iter=3000, gait_trials=8, gait_distinct=2, gait_samples=4000,
    n_check=2, batch=(6, 24, 8), lags=3, family_trials=2, repeats=1,
)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("captures"))
    paths, emgs, fs = cs.phase_ingest(TINY, workdir, 0)
    return workdir, paths, emgs, fs


def _env(**extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def test_phase_ingest(captures, capsys):
    _, paths, emgs, fs = captures
    assert len(paths) == TINY.n_files and fs == 2000.0
    assert all(e.array.shape[1] == 8 for e in emgs)


def test_phase_preprocess(captures, capsys):
    _, _, emgs, fs = captures
    cs.phase_preprocess(emgs, fs)
    out = capsys.readouterr().out
    assert "preprocess: envelope" in out and "rms" in out


def test_phase_solve(captures, capsys):
    workdir, paths, _, _ = captures
    cs.phase_solve(TINY, paths, workdir)
    out = capsys.readouterr().out
    assert "solve cd:" in out and "solve mu:" in out
    assert "solve gait batch" in out


def test_phase_families(captures, capsys):
    workdir, paths, emgs, fs = captures
    cs.phase_families(TINY, paths, emgs, fs, workdir)
    out = capsys.readouterr().out
    assert "cnmf@default" in out and "nm3f@highest" in out


def test_phase_kernels_in_interpret_mode(capsys):
    rows = cs.phase_kernels(TINY, 0, interpret=True)
    assert [family for family, _, _ in rows] == ["mu", "cd", "kl", "is"]


def test_phase_serve(captures, capsys):
    _, _, emgs, fs = captures
    cs.phase_serve(TINY, emgs, fs)
    out = capsys.readouterr().out
    assert "symbolic batch 5" in out and "cuda+cpu" in out


def test_phase_mesh_on_four_virtual_devices(captures, capsys):
    import jax

    assert jax.device_count() >= 4  # the suite's virtual CPU devices
    _, _, emgs, fs = captures
    cs.phase_mesh(TINY, emgs, fs)
    out = capsys.readouterr().out
    assert "sharded_fit_cnmf" in out


def test_phase_device_requires_a_gpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.phase_device(1)


def test_exits_nonzero_on_the_cpu():
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
    assert "needs a GPU" in result.stderr


def test_exits_nonzero_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


_BLOCKED = """
import sys
# flatbuffers too: phase 7 then runs the lowered programs in memory
for name in ("pandas", "sklearn", "matplotlib", "flatbuffers"):
    sys.modules[name] = None
import dataclasses, tempfile
import muscle_synergies_tpu  # the package imports without them
import chip_smoke as cs
tiny = dataclasses.replace(cs.FULL, n_files=2, state_len=60, n_markers=4,
    ranks=(1, 2), max_iter=500, gait_trials=4, gait_distinct=2,
    gait_samples=4000, n_check=2, batch=(4, 24, 8), lags=3, repeats=1)
with tempfile.TemporaryDirectory() as d:
    paths, emgs, fs = cs.phase_ingest(tiny, d, 0)
    cs.phase_preprocess(emgs, fs)
    cs.phase_solve(tiny, paths, d)
    cs.phase_kernels(tiny, 0, interpret=True)
    cs.phase_serve(tiny, emgs, fs)
assert all(sys.modules.get(n) is None
           for n in ("pandas", "sklearn", "matplotlib", "flatbuffers"))
print("ARRAY_PATH_OK")
"""


def test_array_path_runs_without_pandas_sklearn_matplotlib():
    result = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    assert "ARRAY_PATH_OK" in result.stdout
