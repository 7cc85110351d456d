"""The benchmark and entry scripts keep emitting their contracts.

Runs ``bench.py --quick`` and ``__graft_entry__.py`` as subprocesses on
the CPU platform (asked for explicitly) and validates their outputs, so
regressions in the benchmark/entry plumbing surface in CI.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=420, platforms="cpu"):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platforms
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable] + args,
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_bench_quick_emits_json_contract():
    result = _run(["bench.py", "--quick", "--impl", "xla"])
    assert result.returncode == 0, result.stderr[-2000:]
    line = result.stdout.strip().splitlines()[-1]
    payload = json.loads(line)
    assert set(payload) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert payload["metric"] == "mu_nmf_iterations_per_sec_per_chip"
    assert payload["value"] > 0
    assert payload["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_graft_entry_runs_single_and_multichip():
    result = _run(["__graft_entry__.py"])
    assert result.returncode == 0, result.stderr[-2000:]
    assert "entry(): compiled and ran" in result.stdout
    assert "dryrun_multichip(8): OK" in result.stdout


def test_bench_vaf_metric_emits_json_contract():
    result = _run(["bench.py", "--quick", "--impl", "xla", "--metric", "vaf"])
    assert result.returncode == 0, result.stderr[-2000:]
    payload = json.loads(result.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(payload)
    assert payload["metric"] == "time_to_90pct_vaf"
    assert payload["value"] > 0
    assert payload["vs_baseline"] > 1  # faster than sklearn's trial loop


@pytest.mark.parametrize("solver", ["cd", "kl", "is", "cnmf", "nm3f"])
def test_bench_solver_axis_emits_json_contract(solver):
    """Every solver runs through the one bench harness."""
    result = _run(
        ["bench.py", "--quick", "--impl", "xla", "--solver", solver]
    )
    assert result.returncode == 0, result.stderr[-2000:]
    payload = json.loads(result.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "date"} <= set(payload)
    assert payload["metric"] == f"{solver}_nmf_iterations_per_sec_per_chip"
    assert payload["value"] > 0


def test_bench_check_validates_kernel_numerics():
    result = _run(["bench.py", "--quick", "--check"], timeout=600)
    assert result.returncode == 0, result.stderr[-2000:]
    payload = json.loads(result.stdout.strip().splitlines()[-1])
    assert payload["metric"] == "solver_parity_max_rel_err"
    assert payload["vs_baseline"] == 1.0
    assert "impl=auto on cpu" in payload["unit"]


def test_dryrun_with_more_devices_than_requested():
    """dryrun_multichip(n) must use the first n of >n available devices."""
    code = "import __graft_entry__ as g; g.dryrun_multichip(4); print('OK4')"
    result = _run(["-c", code])
    assert result.returncode == 0, result.stderr[-2000:]
    assert "OK4" in result.stdout


def test_bench_flag_validation_precedes_backend_probe():
    """Pure argument errors fail before any device work."""
    for flags, msg in [
        (["--solver", "nm3f", "--impl", "pallas"], "no Pallas kernel"),
        (["--metric", "vaf", "--solver", "cnmf"], "mu/cd/kl/is only"),
    ]:
        result = _run(["bench.py", *flags], timeout=60)
        assert result.returncode != 0
        assert msg in result.stderr


def test_bench_requires_a_gpu_unless_cpu_is_explicit():
    """Without a GPU and without JAX_PLATFORMS=cpu, no number is taken."""
    result = _run(["bench.py", "--quick"], timeout=120, platforms="")
    assert result.returncode != 0
    assert "measures a GPU" in result.stderr
    assert "metric" not in result.stdout
