"""The ``python -m muscle_synergies_tpu`` command-line surface."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capture_csv(tmp_path_factory):
    from muscle_synergies_tpu.testing import write_synthetic_capture

    path = tmp_path_factory.mktemp("cli") / "trial.csv"
    # small capture: 2 trechos keep the CLI tests fast
    return write_synthetic_capture(str(path), state_len=300, n_trechos=2)


def _run(args, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "muscle_synergies_tpu", "--platform", "cpu"]
        + args,
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_describe_prints_summary(capture_csv):
    result = _run(["describe", capture_csv])
    assert result.returncode == 0, result.stderr[-2000:]
    assert "emg: 8 columns" in result.stdout
    assert "2000 Hz" in result.stdout


def test_analyze_writes_json_report(capture_csv, tmp_path):
    out = tmp_path / "report.json"
    result = _run([
        "analyze", capture_csv, "--ranks", "2:3", "--rms", "0.5",
        "--max-iter", "500", "--tol", "1e-5", "--components",
        "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert set(report["ranks"]) == {"2", "3"}
    r2 = report["ranks"]["2"]
    assert 0.5 < r2["vaf_overall"] <= 1.0
    assert len(r2["vaf_per_muscle"]) == 8
    assert r2["n_iter"] >= 1
    assert len(r2["components"]) == 2  # rank-2 synergy matrix rows


def test_analyze_single_rank_to_stdout(capture_csv):
    result = _run([
        "analyze", capture_csv, "--ranks", "2", "--rms", "0.5",
        "--max-iter", "200", "--tol", "1e-4", "--solver", "mu",
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(result.stdout)
    assert list(report["ranks"]) == ["2"]


def test_bad_ranks_spec_gives_clear_error(capture_csv):
    for spec in ["-3", ":4", "5:2", "abc", "0"]:
        result = _run(["analyze", capture_csv, "--ranks", spec])
        assert result.returncode == 2, (spec, result.stderr[-500:])
        assert "invalid --ranks" in result.stderr, (spec, result.stderr[-500:])


def test_analyze_dataset_groups_subjects(capture_csv, tmp_path):
    out = tmp_path / "dataset.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--ranks", "1:2", "--rms", "0.5", "--max-iter", "300",
        "--tol", "1e-5", "--subjects", "s1,s2", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["ranks"] == [1, 2]
    assert set(report["subject_mean_vaf"]) == {"s1", "s2"}
    assert len(report["vaf_overall"]) == 2  # aligned with files
    assert all(
        0 < v <= 1
        for ranks in report["vaf_overall"]
        for v in ranks.values()
    )
    assert len(report["min_rank_reaching_0.9"]) == 2


def test_analyze_dataset_cluster_subjects(capture_csv, tmp_path):
    out = tmp_path / "dataset.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--ranks", "1:2", "--rms", "0.5", "--max-iter", "300",
        "--tol", "1e-5", "--subjects", "s1,s2",
        "--cluster-subjects", "2", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    section = report["synergy_clusters"]
    assert section["rank"] == 2
    assert section["subjects"] == ["s1", "s2"]
    # identical captures: every cluster is shared by both subjects
    assert section["n_clusters"] == 2
    assert section["shared"] == [0, 1]
    assert section["coverage"] == [1.0, 1.0]
    assert len(section["membership"]) == 2
    assert all(len(row) == 2 for row in section["membership"])
    assert len(section["consensus"]) == 2


def test_analyze_dataset_cluster_subjects_validation(capture_csv):
    # needs --subjects with two distinct labels
    r = _run([
        "analyze-dataset", capture_csv, capture_csv, "--ranks", "2",
        "--rms", "0.5", "--cluster-subjects", "2",
    ])
    assert r.returncode != 0 and "two distinct" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, capture_csv, "--ranks", "2",
        "--rms", "0.5", "--subjects", "a,a", "--cluster-subjects", "2",
    ])
    assert r.returncode != 0 and "two distinct" in r.stderr
    # rank must be inside the sweep
    r = _run([
        "analyze-dataset", capture_csv, capture_csv, "--ranks", "1:2",
        "--rms", "0.5", "--subjects", "a,b", "--cluster-subjects", "3",
    ])
    assert r.returncode != 0 and "outside the swept ranks" in r.stderr
    # plain rank sweep only
    r = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--space-by-time", "2:2", "--rms", "0.5",
        "--subjects", "a,b", "--cluster-subjects", "2",
    ])
    assert r.returncode != 0 and "plain NMF rank sweep" in r.stderr


def test_analyze_dataset_rejects_mismatched_subjects(capture_csv):
    result = _run([
        "analyze-dataset", capture_csv, "--subjects", "a,b",
        "--ranks", "1", "--rms", "0.5", "--max-iter", "50",
    ])
    assert result.returncode != 0
    assert "labels" in result.stderr


def test_analyze_plot_writes_figures(capture_csv, tmp_path):
    plots = tmp_path / "figs"
    result = _run([
        "analyze", capture_csv, "--ranks", "2:3", "--rms", "0.5",
        "--max-iter", "200", "--tol", "1e-4", "--plot", str(plots),
        "-o", str(tmp_path / "r.json"),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    names = {p.name for p in plots.iterdir()}
    assert names == {
        "processed_signals.png", "synergies_rank2.png",
        "synergies_rank3.png",
    }
    assert all((plots / n).stat().st_size > 1000 for n in names)


def test_malformed_csv_gives_clean_error(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("NotDevices\n300\n")
    result = _run(["describe", str(bad)])
    assert result.returncode == 1
    assert "Traceback" not in result.stderr
    assert "bad.csv" in result.stderr
    result = _run(["analyze", str(tmp_path / "missing.csv"), "--ranks", "2"])
    assert result.returncode == 1
    assert "no such file" in result.stderr


def test_analyze_dataset_sparsity_flags(capture_csv, tmp_path):
    """--alpha-w/--l1-ratio reach the batched dataset solve and bias
    the factors sparser than the unpenalized run."""
    out_plain = tmp_path / "plain.json"
    out_sparse = tmp_path / "sparse.json"
    common = [
        "analyze-dataset", capture_csv, "--ranks", "2", "--rms", "0.5",
        "--max-iter", "300", "--tol", "1e-5", "--solver", "mu",
    ]
    r1 = _run(common + ["-o", str(out_plain)])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run(common + [
        "--alpha-w", "0.1", "--l1-ratio", "1.0", "-o", str(out_sparse),
    ])
    assert r2.returncode == 0, r2.stderr[-2000:]
    plain = json.loads(out_plain.read_text())
    sparse = json.loads(out_sparse.read_text())
    # the L1 penalty can only lower the attainable VAF
    v_plain = plain["vaf_overall"][0]["2"]
    v_sparse = sparse["vaf_overall"][0]["2"]
    assert v_sparse <= v_plain + 1e-9


def test_analyze_time_varying_report(capture_csv, tmp_path):
    out = tmp_path / "tv.json"
    plots = tmp_path / "tvfigs"
    result = _run([
        "analyze", capture_csv, "--ranks", "2", "--rms", "0.5",
        "--time-varying", "8", "--n-inits", "2", "--max-iter", "300",
        "--tol", "1e-4", "--components", "--plot", str(plots),
        "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["pipeline"]["model"] == "time-varying"
    assert report["pipeline"]["lags"] == 8
    assert report["rank"] == 2
    assert 0.0 < report["vaf_overall"] <= 1.0
    assert len(report["vaf_per_muscle"]) == 8
    assert len(report["restart_errors"]) == 2
    # each synergy is a lags x muscles pattern
    assert set(report["synergies"]) == {"0", "1"}
    assert len(report["synergies"]["0"]) == 8
    assert len(report["synergies"]["0"][0]) == 8
    names = {p.name for p in plots.iterdir()}
    assert names == {"processed_signals.png", "time_varying_synergies.png"}


def test_analyze_time_varying_rejects_bad_flag_combos(capture_csv):
    base = ["analyze", capture_csv, "--rms", "0.5", "--time-varying", "8"]
    r = _run(base)  # no --ranks at all: must not blame the 1:4 default
    assert r.returncode == 1
    assert "requires an explicit --ranks" in r.stderr
    r = _run(base + ["--ranks", "2:3"])
    assert r.returncode == 1
    assert "single --ranks" in r.stderr
    r = _run(base + ["--ranks", "2", "--beta-loss", "kullback-leibler"])
    assert r.returncode == 1
    assert "Frobenius-only" in r.stderr
    r = _run(base + ["--ranks", "2", "--alpha-w", "0.1"])
    assert r.returncode == 1
    assert "sparsity" in r.stderr
    r = _run(base + ["--ranks", "2", "--alpha-h", "0.3"])
    assert r.returncode == 1
    assert "alpha-h" in r.stderr
    r = _run(base + ["--ranks", "2", "--solver", "mu"])
    assert r.returncode == 1
    assert "drop --solver" in r.stderr
    r = _run(base + ["--ranks", "2", "--inner-iter", "3"])
    assert r.returncode == 1
    assert "inner-iter" in r.stderr


def test_analyze_dataset_time_varying(capture_csv, tmp_path):
    out = tmp_path / "ds_tv.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv, "--ranks", "2",
        "--time-varying", "8", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "200", "--tol", "1e-4",
        "--subjects", "s1,s1", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["model"] == "time-varying"
    assert report["rank"] == 2
    assert len(report["vaf_overall"]) == 2
    # identical captures: restart seeds differ per trial, but both
    # should land in the same VAF regime
    assert abs(report["vaf_overall"][0] - report["vaf_overall"][1]) < 0.2
    assert all(0.0 < v <= 1.0 for v in report["vaf_overall"])
    assert len(report["restart_errors"][0]) == 2
    assert "s1" in report["subject_mean_vaf"]
    r = _run([
        "analyze-dataset", capture_csv, "--ranks", "2:3",
        "--time-varying", "8",
    ])
    assert r.returncode == 1
    assert "single --ranks" in r.stderr


def test_analyze_dataset_space_by_time(capture_csv, tmp_path):
    out = tmp_path / "sbt.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--space-by-time", "3:2", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "200", "--tol", "1e-4",
        "--subjects", "s1,s1", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["model"] == "space-by-time"
    assert report["n_temporal"] == 3 and report["n_spatial"] == 2
    assert 0.0 < report["vaf_overall"] <= 1.0
    assert len(report["vaf_per_trial"]) == 2
    assert len(report["coefficients"]) == 2  # one matrix per capture
    assert len(report["coefficients"][0]) == 3
    assert len(report["coefficients"][0][0]) == 2
    assert len(report["temporal_modules"][0]) == 3
    assert len(report["spatial_modules"]["rows"]) == 2
    assert len(report["spatial_modules"]["columns"]) == 8
    # flag hygiene: both models at once, leftover rank-sweep flags
    r = _run([
        "analyze-dataset", capture_csv, "--space-by-time", "3:2",
        "--time-varying", "8", "--ranks", "2",
    ])
    assert r.returncode == 1 and "pick one" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, "--space-by-time", "3:2",
        "--ranks", "2",
    ])
    assert r.returncode == 1 and "drop --ranks" in r.stderr
    r = _run(["analyze-dataset", capture_csv, "--space-by-time", "nope"])
    assert r.returncode == 2 and "space-by-time" in r.stderr


def test_analyze_dataset_rejects_bad_alpha_h(capture_csv):
    result = _run([
        "analyze-dataset", capture_csv, "--ranks", "1", "--rms", "0.5",
        "--max-iter", "50", "--alpha-h", "bogus",
    ])
    assert result.returncode != 0
    assert "alpha-h" in result.stderr


def test_analyze_dataset_shared_factor_models(capture_csv, tmp_path):
    out = tmp_path / "tmod.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--temporal-modules", "3", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "150", "--tol", "1e-4", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["model"] == "temporal"
    assert report["n_modules"] == 3
    assert 0.0 < report["vaf_overall"] <= 1.0
    assert len(report["temporal_modules"][0]) == 3
    assert len(report["weights"]["per_capture"]) == 2
    assert len(report["weights"]["columns"]) == 8

    out2 = tmp_path / "smod.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--spatial-modules", "2", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "150", "--tol", "1e-4", "-o", str(out2),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out2.read_text())
    assert report["model"] == "shared-spatial"
    assert len(report["spatial_modules"]["rows"]) == 2
    assert len(report["spatial_modules"]["columns"]) == 8
    assert len(report["activations"]) == 2

    # flag hygiene: model exclusivity and leftover rank-sweep flags
    r = _run([
        "analyze-dataset", capture_csv, "--temporal-modules", "3",
        "--spatial-modules", "2",
    ])
    assert r.returncode == 1 and "pick one" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, "--spatial-modules", "2",
        "--ranks", "2",
    ])
    assert r.returncode == 1 and "drop --ranks" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, "--temporal-modules", "0",
    ])
    assert r.returncode == 1 and ">= 1" in r.stderr


def test_analyze_dataset_prefetch_pipeline(capture_csv, tmp_path):
    out = tmp_path / "pipelined.json"
    result = _run([
        "analyze-dataset", capture_csv, capture_csv, capture_csv,
        "--ranks", "1:2", "--rms", "0.5", "--max-iter", "300",
        "--tol", "1e-5", "--prefetch", "2", "--chunk-files", "2",
        "--subjects", "s1,s1,s2", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["ranks"] == [1, 2]
    assert report["sampling_frequency"] == 2000.0
    assert len(report["vaf_overall"]) == 3
    assert set(report["subject_mean_vaf"]) == {"s1", "s2"}


def test_analyze_dataset_prefetch_validation(capture_csv):
    r = _run([
        "analyze-dataset", capture_csv, "--prefetch", "2",
        "--space-by-time", "2:2", "--rms", "0.5",
    ])
    assert r.returncode != 0 and "plain NMF rank sweep" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, "--prefetch", "2",
        "--chunk-files", "0", "--rms", "0.5",
    ])
    assert r.returncode != 0 and "--chunk-files" in r.stderr
    r = _run([
        "analyze-dataset", capture_csv, "/nonexistent.csv",
        "--prefetch", "1", "--ranks", "1", "--rms", "0.5",
    ])
    assert r.returncode != 0 and "no such file" in r.stderr


def test_precision_flag(capture_csv, tmp_path):
    """--precision threads to the shared-factor/convolutive models and
    is rejected on the plain rank sweep (whose production path is the
    pure-f32 Pallas solvers)."""
    out = tmp_path / "sbt_hi.json"
    result = _run([
        "analyze-dataset", capture_csv,
        "--space-by-time", "2:2", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "100", "--tol", "1e-4",
        "--precision", "highest", "-o", str(out),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["model"] == "space-by-time"
    assert 0.0 < report["vaf_overall"] <= 1.0

    r = _run([
        "analyze-dataset", capture_csv, "--ranks", "2",
        "--rms", "0.5", "--precision", "highest",
    ])
    assert r.returncode == 1 and "drop it" in r.stderr

    r = _run([
        "analyze-dataset", capture_csv, "--ranks", "2",
        "--precision", "sloppy",
    ])
    assert r.returncode == 2  # argparse choice error


def test_analyze_save_model_round_trips(capture_csv, tmp_path):
    """--save-model persists the run; reloads support transform."""
    out = tmp_path / "report.json"
    model_path = tmp_path / "fitted"
    result = _run([
        "analyze", capture_csv, "--ranks", "2:3", "--rms", "0.5",
        "--max-iter", "300", "--tol", "1e-4",
        "-o", str(out), "--save-model", str(model_path),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    assert "model saved to" in result.stdout
    from muscle_synergies_tpu.models import load_synergy_run

    run = load_synergy_run(tmp_path / "fitted.npz")
    assert sorted(run.model) == [2, 3]
    report = json.loads(out.read_text())
    for rank in (2, 3):
        assert run.model[rank].n_iter_ == report["ranks"][str(rank)]["n_iter"]


def test_analyze_time_varying_save_model(capture_csv, tmp_path):
    result = _run([
        "analyze", capture_csv, "--ranks", "2", "--time-varying", "6",
        "--rms", "0.5", "--max-iter", "50", "--n-inits", "2",
        "--save-model", str(tmp_path / "tv"),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    from muscle_synergies_tpu.models import CNMFModel

    model = CNMFModel.load(tmp_path / "tv.npz")
    assert model.synergies_.shape == (2, 6, 8)
    assert model.n_components_ == 2 and model.n_lags_ == 6


def test_analyze_dataset_save_model_shared_modules(capture_csv, tmp_path):
    """--save-model persists shared-module models; per-trial models
    are rejected with a pointer to `analyze --save-model`."""
    result = _run([
        "analyze-dataset", capture_csv, capture_csv,
        "--spatial-modules", "2", "--n-inits", "2", "--rms", "0.5",
        "--max-iter", "60", "--save-model", str(tmp_path / "smod"),
    ])
    assert result.returncode == 0, result.stderr[-2000:]
    from muscle_synergies_tpu.models import NM3FModel
    import numpy as np

    model = NM3FModel.load(tmp_path / "smod.npz")
    assert model.spatial_modules_.shape[0] == 2
    # sMod = NM3F with the temporal side frozen at identity
    np.testing.assert_array_equal(
        model.temporal_modules_,
        np.eye(model.temporal_modules_.shape[0]),
    )

    r = _run([
        "analyze-dataset", capture_csv, "--ranks", "2",
        "--save-model", str(tmp_path / "nope"),
    ])
    assert r.returncode == 1
    assert "requires a shared-module model" in r.stderr


def test_export_transform_cli(capture_csv, tmp_path):
    """analyze --save-model -> export-transform -> jax-only serving."""
    result = _run([
        "analyze", capture_csv, "--ranks", "2:3", "--rms", "0.5",
        "--max-iter", "200", "--tol", "1e-4",
        "--save-model", str(tmp_path / "run"),
    ])
    assert result.returncode == 0, result.stderr[-2000:]

    # sweep payloads need --rank
    r = _run([
        "export-transform", str(tmp_path / "run.npz"),
        "--shape", "200,8", "-o", str(tmp_path / "t.hlo"),
    ])
    assert r.returncode == 1 and "--rank" in r.stderr

    r = _run([
        "export-transform", str(tmp_path / "run.npz"), "--rank", "2",
        "--shape", "b,8", "-o", str(tmp_path / "t.hlo"),
    ])
    assert r.returncode == 0, r.stderr[-2000:]

    import numpy as np

    from muscle_synergies_tpu.models import load_transform

    fn = load_transform(tmp_path / "t.hlo")
    assert fn.exported.platforms == ("cpu", "cuda")
    x = np.abs(RNG_EXPORT.normal(size=(37, 8))).astype("float32")
    assert fn(x).shape == (37, 2)  # symbolic rows: any length serves


RNG_EXPORT = __import__("numpy").random.default_rng(3)
