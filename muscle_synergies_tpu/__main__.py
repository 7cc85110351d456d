"""Command-line entry point: ``python -m muscle_synergies_tpu``.

The reference is library-only (SURVEY §1: "no scheduler, no server, no
CLI"); production deployments want a shell-scriptable surface, so this
module exposes the two everyday operations:

``describe``
    Parse a Vicon Nexus CSV export and print the capture summary
    (devices, shapes, sampling rates).

``analyze``
    Run the full pipeline — load, preprocess (linear envelope or
    moving RMS, time/amplitude normalization), VAF rank sweep — and
    write a JSON report (per-rank overall + per-muscle VAF, solver
    telemetry, optional components).

Both run on whatever JAX backend is active (a GPU in production, the
CPU elsewhere); ``--platform cpu`` forces the CPU backend before any
device query.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cli_precision(args):
    """``--precision default`` -> None (the XLA default), else the name."""
    return None if args.precision == "default" else args.precision


def _parse_ranks(spec: str):
    """``"4"`` -> (4, None); ``"2:5"`` / ``"2-5"`` -> (2, 5).

    Raises ``argparse.ArgumentTypeError`` with the offending spec on
    anything else (empty bounds, non-integers, inverted ranges).
    """
    def _bad(why):
        raise argparse.ArgumentTypeError(
            f"invalid --ranks {spec!r}: {why} (expected e.g. '3' or '2:5')"
        )

    sep = ":" if ":" in spec else "-" if "-" in spec.strip("-") else None
    try:
        if sep:
            lo_s, hi_s = spec.split(sep, 1)
            lo, hi = int(lo_s), int(hi_s)
        else:
            lo, hi = int(spec), None
    except ValueError:
        _bad("not an integer or integer range")
    if lo < 1:
        _bad("ranks start at 1")
    if hi is not None and hi < lo:
        _bad("range upper bound below lower bound")
    return lo, hi


def _parse_modules(spec: str):
    """``"3:2"`` -> (3, 2): temporal x spatial module counts."""
    try:
        p_s, q_s = spec.split(":", 1)
        p, q = int(p_s), int(q_s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid --space-by-time {spec!r}: expected 'P:Q' module "
            "counts, e.g. '3:2'"
        )
    if p < 1 or q < 1:
        raise argparse.ArgumentTypeError(
            f"invalid --space-by-time {spec!r}: module counts start at 1"
        )
    return p, q


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m muscle_synergies_tpu",
        description="accelerated muscle-synergy analysis",
    )
    parser.add_argument(
        "--platform", default=None,
        help="force a JAX platform (e.g. 'cpu') before any device query",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_desc = sub.add_parser("describe", help="summarize a Vicon CSV export")
    p_desc.add_argument("csv", help="path to the Vicon Nexus CSV export")

    p_an = sub.add_parser("analyze", help="EMG -> synergies pipeline")
    p_an.add_argument("csv", help="path to the Vicon Nexus CSV export")
    p_an.add_argument(
        "--ranks", type=_parse_ranks, default=None,
        help="rank or range to sweep, e.g. '3' or '2:5' (default 1:4; "
             "--time-varying requires an explicit single value)",
    )
    p_an.add_argument(
        "--solver", choices=["cd", "mu"], default=None,
        help="NMF solver (default: cd, sklearn's default)",
    )
    p_an.add_argument(
        "--beta-loss", default="frobenius",
        help="frobenius | kullback-leibler | itakura-saito | float beta "
             "(non-Frobenius requires --solver mu)",
    )
    p_an.add_argument("--max-iter", type=int, default=100_000)
    p_an.add_argument("--tol", type=float, default=1e-6)
    p_an.add_argument(
        "--alpha-w", type=float, default=0.0,
        help="sklearn-scaled sparsity strength on W (default 0: none)",
    )
    p_an.add_argument(
        "--alpha-h", default="same",
        help="sparsity strength on H: a float, or 'same' as --alpha-w "
             "(default)",
    )
    p_an.add_argument(
        "--l1-ratio", type=float, default=0.0,
        help="L1/L2 mix for the sparsity penalties (0 = pure L2, "
             "1 = pure L1; default 0)",
    )
    p_an.add_argument(
        "--inner-iter", type=int, default=1,
        help="accelerated-MU inner repetitions per outer iteration "
             "(Frobenius MU only; 1 = sklearn-exact)",
    )
    p_an.add_argument(
        "--time-varying", type=int, metavar="LAGS", default=None,
        help="extract d'Avella-style time-varying synergies instead of "
             "time-invariant NMF: each synergy is a LAGS-sample "
             "spatiotemporal pattern (convolutive NMF; takes a single "
             "--ranks value)",
    )
    p_an.add_argument(
        "--n-inits", type=int, default=4,
        help="random restarts for --time-varying, batched into one "
             "device dispatch (default 4)",
    )
    p_an.add_argument(
        "--impl", choices=["auto", "xla", "pallas"], default="auto",
        help="--time-varying solver implementation (no hand-written "
             "kernel: auto and xla both run the batched XLA fit)",
    )
    p_an.add_argument(
        "--precision", choices=["default", "highest"], default="default",
        help="matmul precision of the --time-varying contractions "
             "('highest' = full float32 products; the default lets the "
             "platform round float32 products through TF32 or bf16)",
    )
    p_an.add_argument(
        "--rms", type=float, metavar="SECONDS", default=None,
        help="moving-RMS smoothing window instead of the filtered "
             "envelope (e.g. 0.5)",
    )
    p_an.add_argument(
        "--envelope-hz", type=float, default=4.0,
        help="low-pass cutoff for the linear envelope (default 4 Hz)",
    )
    p_an.add_argument(
        "--reduce-to", type=int, default=200,
        help="time-normalization length (default 200)",
    )
    p_an.add_argument(
        "--output", "-o", default=None,
        help="write the JSON report here (default: stdout)",
    )
    p_an.add_argument(
        "--components", action="store_true",
        help="include the synergy component matrices in the report",
    )
    p_an.add_argument(
        "--plot", metavar="DIR", default=None,
        help="save figures here: processed signals and one synergy "
             "heatmap per rank (PNG)",
    )
    p_an.add_argument(
        "--save-model", metavar="PATH", default=None,
        help="persist the fitted model as a pickle-free .npz: the "
             "whole run (VAF table + components + models, reload with "
             "models.load_synergy_run) for time-invariant NMF, or a "
             "CNMFModel (CNMFModel.load) for --time-varying",
    )

    p_ds = sub.add_parser(
        "analyze-dataset",
        help="batched EMG -> synergies across many captures (one device "
             "program for the whole trial x rank grid)",
    )
    p_ds.add_argument("csvs", nargs="+", help="Vicon Nexus CSV exports")
    p_ds.add_argument(
        "--ranks", type=_parse_ranks, default=None,
        help="rank or range to sweep (default 1:4; --time-varying "
             "requires an explicit single value)",
    )
    p_ds.add_argument(
        "--subjects", default=None,
        help="comma-separated subject label per capture (enables "
             "grouped reporting)",
    )
    p_ds.add_argument("--solver", choices=["cd", "mu"], default=None)
    p_ds.add_argument("--beta-loss", default="frobenius")
    p_ds.add_argument("--max-iter", type=int, default=10_000)
    p_ds.add_argument("--tol", type=float, default=1e-6)
    p_ds.add_argument(
        "--alpha-w", type=float, default=0.0,
        help="sklearn-scaled sparsity strength on W (default 0: none)",
    )
    p_ds.add_argument(
        "--alpha-h", default="same",
        help="sparsity strength on H: a float, or 'same' as --alpha-w "
             "(default)",
    )
    p_ds.add_argument(
        "--l1-ratio", type=float, default=0.0,
        help="L1/L2 mix for the sparsity penalties (0 = pure L2, "
             "1 = pure L1; default 0)",
    )
    p_ds.add_argument(
        "--rms", type=float, metavar="SECONDS", default=None,
        help="moving-RMS window instead of the filtered envelope",
    )
    p_ds.add_argument("--reduce-to", type=int, default=200)
    p_ds.add_argument(
        "--impl", choices=["auto", "xla", "pallas"], default="auto",
        help="batched-solver implementation (default auto: the fused "
             "Triton kernels on a GPU, XLA elsewhere)",
    )
    p_ds.add_argument(
        "--precision", choices=["default", "highest"], default="default",
        help="matmul precision for the --time-varying/--space-by-time/"
             "--temporal-modules/--spatial-modules models' XLA "
             "contractions ('highest' = full float32 products; the "
             "plain rank sweep always runs full float32 and rejects "
             "this flag)",
    )
    p_ds.add_argument(
        "--vaf-threshold", type=float, default=0.90,
        help="threshold for the minimum-rank report (default 0.90)",
    )
    p_ds.add_argument(
        "--prefetch", type=int, metavar="N", default=0,
        help="pipeline the load: a producer thread parses the next "
             "captures and stages them on device (up to N chunks "
             "ahead) while the current chunk preprocesses and fits "
             "(plain rank sweep only; 0 = off)",
    )
    p_ds.add_argument(
        "--chunk-files", type=int, metavar="K", default=2,
        help="captures per pipeline stage under --prefetch (default 2)",
    )
    p_ds.add_argument(
        "--time-varying", type=int, metavar="LAGS", default=None,
        help="extract time-varying (convolutive) synergies per capture "
             "instead of the NMF rank sweep; takes a single --ranks "
             "value (the synergy count)",
    )
    p_ds.add_argument(
        "--space-by-time", type=_parse_modules, metavar="P:Q",
        default=None,
        help="extract a Delis-style space-by-time decomposition of the "
             "whole dataset instead of the NMF rank sweep: P shared "
             "temporal modules x Q shared spatial modules with one "
             "coefficient matrix per capture (e.g. '3:2')",
    )
    p_ds.add_argument(
        "--temporal-modules", type=int, metavar="P", default=None,
        help="extract the shared-temporal model (Delis tMod) instead "
             "of the NMF rank sweep: P temporal modules shared by the "
             "whole dataset, one muscle-weight matrix per capture",
    )
    p_ds.add_argument(
        "--spatial-modules", type=int, metavar="Q", default=None,
        help="extract the shared-spatial model (Delis sMod) instead "
             "of the NMF rank sweep: Q spatial modules shared by the "
             "whole dataset, one activation train per capture",
    )
    p_ds.add_argument(
        "--n-inits", type=int, default=4,
        help="random restarts for the --time-varying/--space-by-time/"
             "--temporal-modules/--spatial-modules models (all "
             "restarts join one batched solve; default 4)",
    )
    p_ds.add_argument(
        "--cluster-subjects", type=int, metavar="RANK", default=None,
        help="after the rank sweep, cluster the per-subject averaged "
             "components at RANK across subjects (group-level "
             "shared-vs-specific synergies); requires --subjects with "
             "at least two distinct labels and RANK inside --ranks",
    )
    p_ds.add_argument(
        "--save-model", metavar="PATH", default=None,
        help="persist the fitted shared-module model as a pickle-free "
             ".npz NM3FModel (reload with NM3FModel.load); only the "
             "shared-module models have one servable artifact, so this "
             "requires --space-by-time, --temporal-modules or "
             "--spatial-modules",
    )
    p_ds.add_argument("--output", "-o", default=None)

    p_ex = sub.add_parser(
        "export-transform",
        help="serialize a saved model's transform as a StableHLO "
             "artifact (jax.export): serve it with jax alone, no "
             "framework code",
    )
    p_ex.add_argument(
        "model", help="a .npz written by --save-model / model.save()"
    )
    p_ex.add_argument(
        "--shape", required=True,
        help="input signature, comma-separated; non-integer entries "
             "declare symbolic dims (any size at call time), e.g. "
             "'200,8' or 'b,200,8'",
    )
    p_ex.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32",
        help="input dtype baked into the artifact (default float32)",
    )
    p_ex.add_argument(
        "--platforms", default="cpu,cuda",
        help="comma-separated lowering targets (default cpu,cuda)",
    )
    p_ex.add_argument(
        "--rank", type=int, default=None,
        help="when the .npz holds a whole find_synergies run: which "
             "rank's model to export",
    )
    p_ex.add_argument(
        "--output", "-o", required=True,
        help="write the serialized artifact here",
    )
    return parser


def _cmd_export_transform(args) -> int:
    """``export-transform``: persisted npz -> StableHLO artifact."""
    from collections.abc import Mapping

    import jax.numpy as jnp

    from muscle_synergies_tpu.models import export_transform
    from muscle_synergies_tpu.models.persist import (
        RUN_FORMAT,
        load_model,
        load_synergy_run,
    )

    try:
        model = load_model(args.model)
    except ValueError as exc:
        if RUN_FORMAT not in str(exc):
            raise SystemExit(f"{args.model}: {exc}")
        run = load_synergy_run(args.model)
        if isinstance(run.model, Mapping):
            if args.rank is None:
                raise SystemExit(
                    f"{args.model} holds a rank sweep over "
                    f"{sorted(run.model)}; pick one with --rank"
                )
            if args.rank not in run.model:
                raise SystemExit(
                    f"--rank {args.rank} not in the sweep "
                    f"{sorted(run.model)}"
                )
            model = run.model[args.rank]
        else:
            model = run.model

    shape = tuple(
        int(d) if d.strip().lstrip("-").isdigit() else d.strip()
        for d in args.shape.split(",")
    )
    if args.dtype == "float64":
        import jax

        # a f64 signature needs x64 enabled or it silently downcasts
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p)
    try:
        export_transform(
            model, shape, dtype=dtype, platforms=platforms,
            path=args.output,
        )
    except (TypeError, ValueError) as exc:
        raise SystemExit(str(exc))
    print(f"exported {type(model).__name__}.transform to {args.output}")
    return 0


def _validate_time_varying_flags(args):
    """Reject flag combinations --time-varying cannot honor.

    Runs BEFORE any ingest/preprocessing so a bad invocation fails in
    milliseconds, not after parsing a multi-hundred-MB capture.  Every
    time-invariant-only sibling flag is rejected loudly rather than
    silently ignored.
    """
    if args.ranks is None:
        raise SystemExit(
            "--time-varying requires an explicit --ranks K (the "
            "synergy count), e.g. --ranks 2"
        )
    lo, hi = args.ranks
    if hi is not None:
        raise SystemExit(
            "--time-varying takes a single --ranks value (the synergy "
            f"count), not the range {lo}:{hi}"
        )
    if args.solver is not None:
        raise SystemExit(
            "--time-varying has a single solver (convolutive MU); "
            "drop --solver"
        )
    if args.beta_loss != "frobenius":
        raise SystemExit(
            "--time-varying is Frobenius-only; drop --beta-loss"
        )
    if args.alpha_w != 0.0 or args.l1_ratio != 0.0:
        raise SystemExit(
            "--time-varying has no sparsity penalties; drop "
            "--alpha-w/--l1-ratio"
        )
    if getattr(args, "alpha_h", "same") != "same":
        raise SystemExit(
            "--time-varying has no sparsity penalties; drop --alpha-h"
        )
    if getattr(args, "inner_iter", 1) != 1:
        raise SystemExit(
            "--inner-iter applies to the Frobenius MU solver only; "
            "drop it for --time-varying"
        )
    if getattr(args, "vaf_threshold", 0.90) != 0.90:
        raise SystemExit(
            "--vaf-threshold belongs to the rank-sweep report; drop it "
            "for --time-varying"
        )
    return lo


def _load(path):
    """Load a capture, turning parse errors into clean CLI messages."""
    import muscle_synergies_tpu as mst

    try:
        return mst.load_vicon_file(path)
    except FileNotFoundError:
        raise SystemExit(f"{path}: no such file")
    except mst.ViconCSVError as exc:
        raise SystemExit(f"{path}: {exc}")


def _cmd_describe(args) -> int:
    import muscle_synergies_tpu as mst

    data = _load(args.csv)
    print(data.describe())
    print(f"forces/EMG sampling rate: {data.sampling_frequency('emg')} Hz")
    if data.traj:  # marker-less (EMG/force-only) captures are valid
        print(f"trajectory sampling rate: {data.sampling_frequency('traj')} Hz")
    print(f"EMG samples: {data.emg.df.shape[0]}")
    return 0


def _cmd_analyze(args) -> int:
    import numpy as np

    import muscle_synergies_tpu as mst

    if args.time_varying is not None:
        _validate_time_varying_flags(args)
    elif args.ranks is None:
        args.ranks = (1, 4)
    data = _load(args.csv)
    emg_df = data.emg.df
    fs = data.emg.sampling_frequency

    try:
        if args.rms is not None:
            proc = mst.rms(
                mst.zero_center(emg_df), window_size=args.rms,
                sampling_frequency=fs,
            )
        else:
            proc = mst.linear_envelope(
                emg_df, critical_freqs=args.envelope_hz,
                sampling_frequency=fs, order=4,
            ).abs()
        if args.reduce_to:
            proc = mst.time_normalize(proc, reduce_to=args.reduce_to)
        proc = mst.normalize(proc).abs()
    except ValueError as exc:
        # e.g. a capture shorter than the filter's edge padding
        raise SystemExit(f"{args.csv}: {exc}")

    lo, hi = args.ranks
    if args.time_varying is not None:
        return _analyze_time_varying(args, proc, emg_df, fs)
    solver = args.solver if args.solver is not None else "cd"
    try:
        beta_loss = float(args.beta_loss)
    except ValueError:
        beta_loss = args.beta_loss
    try:
        alpha_h = float(args.alpha_h)
    except ValueError:
        if args.alpha_h != "same":
            raise SystemExit(
                f"invalid --alpha-h {args.alpha_h!r}: expected a float "
                "or 'same'"
            )
        alpha_h = "same"
    try:
        result = mst.find_synergies(
            proc, lo, hi, solver=solver, beta_loss=beta_loss,
            max_iter=args.max_iter, tol=args.tol,
            alpha_W=args.alpha_w, alpha_H=alpha_h,
            l1_ratio=args.l1_ratio, inner_iter=args.inner_iter,
            # a rank range solves as ONE zero-rank-padded device dispatch
            # instead of a sequential host loop (per-dispatch latency
            # dominates on remote accelerators)
            sweep="batched" if hi is not None else "loop",
        )
    except ValueError as exc:
        # invalid parameter combinations (e.g. --solver cd with a
        # non-Frobenius --beta-loss) get the same clean exit as
        # missing/malformed capture files
        raise SystemExit(str(exc))

    if isinstance(result.model, dict):
        # rank sweep: vaf_values rows are indexed by rank
        ranks = list(result.vaf_values.index)
        models, comps = result.model, result.components
        rows = {k: result.vaf_values.loc[k] for k in ranks}
    else:
        # single run: one unlabeled row for the requested rank
        ranks = [lo]
        models = {lo: result.model}
        comps = {lo: result.components}
        rows = {lo: result.vaf_values.iloc[0]}
    report = {
        "file": args.csv,
        "sampling_frequency": float(fs),
        "muscles": list(emg_df.columns),
        "pipeline": {
            "smoothing": (
                {"rms_window_s": args.rms} if args.rms is not None
                else {"envelope_lowpass_hz": args.envelope_hz}
            ),
            "reduce_to": args.reduce_to,
            "solver": solver,
            "beta_loss": args.beta_loss,
            "max_iter": args.max_iter,
            "tol": args.tol,
        },
        "ranks": {},
    }
    for k in ranks:
        row = rows[k]
        entry = {
            "vaf_overall": float(row["All signals"]),
            "vaf_per_muscle": {
                m: float(row[m]) for m in emg_df.columns
            },
            "n_iter": int(models[k].n_iter_),
            "reconstruction_err": float(models[k].reconstruction_err_),
        }
        if args.components:
            entry["components"] = np.asarray(comps[k]).tolist()
        report["ranks"][str(k)] = entry

    if args.plot:
        import os

        import matplotlib

        matplotlib.use("Agg")  # headless: files, not windows
        import matplotlib.pyplot as plt

        os.makedirs(args.plot, exist_ok=True)
        fig = mst.plot_signal(proc, title="processed EMG", show=False)
        fig.savefig(os.path.join(args.plot, "processed_signals.png"),
                    bbox_inches="tight")
        plt.close(fig)
        for k in ranks:
            fig = mst.synergy_heatmap(comps[k], show=False)
            fig.savefig(
                os.path.join(args.plot, f"synergies_rank{k}.png"),
                bbox_inches="tight",
            )
            plt.close(fig)
        print(f"figures in {args.plot}")

    if args.save_model:
        print(f"model saved to {result.save(args.save_model)}")

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _analyze_time_varying(args, proc, emg_df, fs) -> int:
    """``analyze --time-varying LAGS``: convolutive-NMF branch.

    The time-invariant flags that have no convolutive counterpart were
    rejected up front by :func:`_validate_time_varying_flags`.
    """
    import numpy as np

    import muscle_synergies_tpu as mst

    lo = _validate_time_varying_flags(args)
    try:
        res = mst.find_time_varying_synergies(
            proc, lo, args.time_varying, max_iter=args.max_iter,
            tol=args.tol, n_inits=args.n_inits, impl=args.impl,
            precision=_cli_precision(args),
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "file": args.csv,
        "sampling_frequency": float(fs),
        "muscles": list(emg_df.columns),
        "pipeline": {
            "smoothing": (
                {"rms_window_s": args.rms} if args.rms is not None
                else {"envelope_lowpass_hz": args.envelope_hz}
            ),
            "reduce_to": args.reduce_to,
            "model": "time-varying",
            "lags": args.time_varying,
            "n_inits": args.n_inits,
            "max_iter": args.max_iter,
            "tol": args.tol,
        },
        "rank": lo,
        "vaf_overall": float(res.vaf),
        "vaf_per_muscle": {
            m: float(res.vaf_per_muscle[m]) for m in emg_df.columns
        },
        "n_iter": int(res.n_iter),
        "restart_errors": [float(e) for e in res.restart_errors],
    }
    if args.components:
        report["synergies"] = {
            str(k): res.synergies[k].to_numpy().tolist()
            for k in res.synergies
        }

    if args.plot:
        import os

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from muscle_synergies_tpu.viz import plot_time_varying_synergies

        os.makedirs(args.plot, exist_ok=True)
        fig = mst.plot_signal(proc, title="processed EMG", show=False)
        fig.savefig(os.path.join(args.plot, "processed_signals.png"),
                    bbox_inches="tight")
        plt.close(fig)
        fig = plot_time_varying_synergies(
            res, sampling_frequency=None, show=False
        )
        fig.savefig(
            os.path.join(args.plot, "time_varying_synergies.png"),
            bbox_inches="tight",
        )
        plt.close(fig)
        print(f"figures in {args.plot}")

    if args.save_model:
        from muscle_synergies_tpu.models import CNMFModel

        model = CNMFModel.from_result(
            res, args.time_varying, tol=args.tol, max_iter=args.max_iter,
            n_inits=args.n_inits, impl=args.impl,
            precision=_cli_precision(args),
        )
        print(f"model saved to {model.save(args.save_model)}")

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _cmd_analyze_dataset(args) -> int:
    import numpy as np

    import muscle_synergies_tpu as mst
    from muscle_synergies_tpu.utils import PipelineConfig

    chosen = [
        name
        for name, value in (
            ("--time-varying", args.time_varying),
            ("--space-by-time", args.space_by_time),
            ("--temporal-modules", args.temporal_modules),
            ("--spatial-modules", args.spatial_modules),
        )
        if value is not None
    ]
    if len(chosen) > 1:
        raise SystemExit(
            " and ".join(chosen) + " are different models; pick one"
        )
    if args.time_varying is not None:
        _validate_time_varying_flags(args)
    elif args.space_by_time is not None:
        _validate_shared_model_flags(args, "--space-by-time")
    elif args.temporal_modules is not None:
        _validate_shared_model_flags(args, "--temporal-modules")
    elif args.spatial_modules is not None:
        _validate_shared_model_flags(args, "--spatial-modules")
    elif args.ranks is None:
        args.ranks = (1, 4)
    if args.save_model is not None \
            and args.space_by_time is None \
            and args.temporal_modules is None \
            and args.spatial_modules is None:
        raise SystemExit(
            "--save-model on analyze-dataset requires a shared-module "
            "model (--space-by-time, --temporal-modules or "
            "--spatial-modules); the rank-sweep and --time-varying "
            "results are per-trial — persist those from "
            "`analyze --save-model`"
        )
    solver = args.solver if args.solver is not None else "cd"
    subjects = None
    if args.subjects:  # validate the cheap flag before any ingest
        subjects = [s.strip() for s in args.subjects.split(",")]
        if len(subjects) != len(args.csvs):
            raise SystemExit(
                f"--subjects gives {len(subjects)} labels for "
                f"{len(args.csvs)} captures"
            )
    if args.cluster_subjects is not None:
        if chosen:
            raise SystemExit(
                "--cluster-subjects applies to the plain NMF rank "
                "sweep only"
            )
        if subjects is None or len(dict.fromkeys(subjects)) < 2:
            raise SystemExit(
                "--cluster-subjects requires --subjects with at least "
                "two distinct labels"
            )

    if args.prefetch < 0:
        raise SystemExit(f"--prefetch must be >= 0, got {args.prefetch}")
    if args.chunk_files < 1:
        raise SystemExit(
            f"--chunk-files must be >= 1, got {args.chunk_files}"
        )
    pipelined = args.prefetch > 0 and not chosen
    if args.prefetch > 0 and chosen:
        raise SystemExit(
            "--prefetch applies to the plain NMF rank sweep only"
        )
    if pipelined:
        # the pipelined loader parses inside the producer thread — the
        # per-file validation (existence, grammar, matching rates)
        # surfaces through analyze_dataset_pipelined instead
        captures = trials = fs = None
    else:
        captures = [_load(p) for p in args.csvs]
        fs = captures[0].emg.sampling_frequency
        for path, cap in zip(args.csvs, captures):
            if cap.emg.sampling_frequency != fs:
                raise SystemExit(
                    f"{path}: EMG sampling rate "
                    f"{cap.emg.sampling_frequency} != {fs} of {args.csvs[0]}"
                )
        trials = [cap.emg for cap in captures]

    shared_model = (
        args.space_by_time is not None
        or args.temporal_modules is not None
        or args.spatial_modules is not None
    )
    if not shared_model:
        # the shared-module branches set module counts through their
        # own flags and reject --ranks up front
        lo, hi = args.ranks
        ranks = tuple(range(lo, (hi if hi is not None else lo) + 1))
        if (
            args.cluster_subjects is not None
            and args.cluster_subjects not in ranks
        ):
            raise SystemExit(
                f"--cluster-subjects {args.cluster_subjects} is outside "
                f"the swept ranks {list(ranks)}"
            )
    try:
        beta_loss = float(args.beta_loss)
    except ValueError:
        beta_loss = args.beta_loss
    try:
        alpha_h = float(args.alpha_h)
    except ValueError:
        if args.alpha_h != "same":
            raise SystemExit(
                f"invalid --alpha-h {args.alpha_h!r}: expected a float "
                "or 'same'"
            )
        alpha_h = "same"
    if not args.reduce_to:
        # analyze_dataset requires a common time base for the batch;
        # "skip" (0) cannot work across ragged captures
        raise SystemExit("--reduce-to must be a positive length")
    config = PipelineConfig(
        use_rms=args.rms is not None,
        rms_window_s=args.rms if args.rms is not None else 0.5,
        reduce_to=args.reduce_to,
    )
    if (
        args.time_varying is None
        and args.space_by_time is None
        and args.temporal_modules is None
        and args.spatial_modules is None
        and args.precision != "default"
    ):
        raise SystemExit(
            "--precision applies to the convolutive/shared-factor "
            "models' XLA contractions; the rank sweep always runs "
            "full float32 — drop it"
        )
    if args.time_varying is not None:
        return _analyze_dataset_time_varying(
            args, trials, fs, config, subjects
        )
    if args.space_by_time is not None:
        return _analyze_dataset_space_by_time(
            args, trials, fs, config, subjects
        )
    if args.temporal_modules is not None or args.spatial_modules is not None:
        return _analyze_dataset_shared_factor(
            args, trials, fs, config, subjects
        )
    try:
        if pipelined:
            res = mst.analyze_dataset_pipelined(
                args.csvs, ranks=ranks, config=config, solver=solver,
                beta_loss=beta_loss, max_iter=args.max_iter, tol=args.tol,
                impl=args.impl, subjects=subjects, alpha_W=args.alpha_w,
                alpha_H=alpha_h, l1_ratio=args.l1_ratio,
                chunk_files=args.chunk_files, prefetch=args.prefetch,
            )
            fs = res.sampling_frequency
        else:
            res = mst.analyze_dataset(
                trials, fs, ranks=ranks, config=config, solver=solver,
                beta_loss=beta_loss, max_iter=args.max_iter, tol=args.tol,
                impl=args.impl, subjects=subjects, alpha_W=args.alpha_w,
                alpha_H=alpha_h, l1_ratio=args.l1_ratio,
            )
    except FileNotFoundError as exc:
        raise SystemExit(f"{exc.filename or exc}: no such file")
    except mst.ViconCSVError as exc:
        raise SystemExit(str(exc))
    except ValueError as exc:
        raise SystemExit(str(exc))

    vaf = np.asarray(res.vaf_overall)  # (R, B)
    min_ranks = res.min_rank_reaching(args.vaf_threshold)
    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "ranks": list(ranks),
        # per-trial sections are lists aligned with "files" (paths may
        # legitimately repeat, so they cannot key a mapping)
        "vaf_overall": [
            {str(k): float(vaf[i, b]) for i, k in enumerate(ranks)}
            for b in range(len(args.csvs))
        ],
        "n_iter": np.asarray(res.n_iter).T.tolist(),  # [trial][rank]
        f"min_rank_reaching_{args.vaf_threshold:g}": [
            (int(r) if r > 0 else None) for r in np.asarray(min_ranks)
        ],
    }
    if subjects:
        report["subjects"] = subjects
        means = res.subject_table("mean")
        report["subject_mean_vaf"] = {
            subj: {str(k): float(v) for k, v in means.loc[subj].items()}
            for subj in dict.fromkeys(subjects)
        }
    if args.cluster_subjects is not None:
        clusters = res.cluster_subjects(args.cluster_subjects)
        report["synergy_clusters"] = {
            "rank": args.cluster_subjects,
            "subjects": list(dict.fromkeys(subjects)),
            "n_clusters": clusters.n_clusters,
            "shared": [int(c) for c in clusters.shared],
            "coverage": [float(c) for c in clusters.coverage],
            # membership[cluster][subject]: component counts
            "membership": clusters.membership.tolist(),
            "consensus": np.asarray(clusters.consensus).tolist(),
        }

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _validate_shared_model_flags(args, name):
    """Reject flags the shared-module models cannot honor (pre-ingest).

    Shared by ``--space-by-time``, ``--temporal-modules`` and
    ``--spatial-modules`` — all three run the batched trilinear MU.
    """
    if args.ranks is not None:
        raise SystemExit(
            f"{name} sets the module count itself; drop --ranks"
        )
    if args.solver is not None:
        raise SystemExit(
            f"{name} has a single solver (trilinear MU); drop --solver"
        )
    if args.beta_loss != "frobenius":
        raise SystemExit(f"{name} is Frobenius-only; drop --beta-loss")
    if args.alpha_w != 0.0 or args.l1_ratio != 0.0 or args.alpha_h != "same":
        raise SystemExit(
            f"{name} has no sparsity penalties; drop "
            "--alpha-w/--alpha-h/--l1-ratio"
        )
    if args.impl != "auto":
        raise SystemExit(
            f"{name} runs the batched XLA trilinear updates; drop --impl"
        )
    if args.vaf_threshold != 0.90:
        raise SystemExit(
            "--vaf-threshold belongs to the rank-sweep report; drop it "
            f"for {name}"
        )
    count = (
        args.temporal_modules
        if args.temporal_modules is not None
        else args.spatial_modules
    )
    if name != "--space-by-time" and count is not None and count < 1:
        raise SystemExit(f"{name} must be >= 1, got {count}")


def _analyze_dataset_space_by_time(args, trials, fs, config, subjects) -> int:
    """``analyze-dataset --space-by-time P:Q``: the NM3F branch."""
    import numpy as np

    import muscle_synergies_tpu as mst

    p, q = args.space_by_time
    try:
        res = mst.analyze_dataset_space_by_time(
            trials, fs, n_temporal=p, n_spatial=q, config=config,
            max_iter=args.max_iter, tol=args.tol, n_inits=args.n_inits,
            subjects=subjects or None, precision=_cli_precision(args),
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "space-by-time",
        "n_temporal": p,
        "n_spatial": q,
        "n_inits": args.n_inits,
        "vaf_overall": float(res.vaf_overall),
        "vaf_per_trial": [float(v) for v in res.vaf_per_trial],
        "vaf_per_muscle": np.asarray(res.vaf_per_channel).tolist(),
        "n_iter": int(res.n_iter),
        "restart_errors": [float(e) for e in res.restart_errors],
        "coefficients": np.asarray(res.coefficients).tolist(),
    }
    if subjects:
        report["subjects"] = subjects
    # the shared modules ARE the dataset-level result; always included
    report["temporal_modules"] = res.temporal_modules.to_numpy().tolist()
    report["spatial_modules"] = {
        "columns": list(map(str, res.spatial_modules.columns)),
        "rows": res.spatial_modules.to_numpy().tolist(),
    }

    if args.save_model:
        from muscle_synergies_tpu.models import NM3FModel

        model = NM3FModel.from_result(
            res, tol=args.tol, max_iter=args.max_iter,
            n_inits=args.n_inits, precision=_cli_precision(args),
        )
        print(f"model saved to {model.save(args.save_model)}")

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _analyze_dataset_shared_factor(args, trials, fs, config, subjects) -> int:
    """``--temporal-modules P`` / ``--spatial-modules Q``: tMod / sMod."""
    import numpy as np

    from muscle_synergies_tpu.dataset import preprocess_trials
    from muscle_synergies_tpu.models import (
        find_shared_spatial_synergies,
        find_temporal_synergies,
    )

    temporal = args.temporal_modules is not None
    k = args.temporal_modules if temporal else args.spatial_modules
    try:
        xs = preprocess_trials(trials, fs, config)
        if temporal:
            res = find_temporal_synergies(
                np.asarray(xs), k, max_iter=args.max_iter, tol=args.tol,
                n_inits=args.n_inits, precision=_cli_precision(args),
            )
        else:
            res = find_shared_spatial_synergies(
                np.asarray(xs), k, max_iter=args.max_iter, tol=args.tol,
                n_inits=args.n_inits, precision=_cli_precision(args),
            )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "temporal" if temporal else "shared-spatial",
        "n_modules": k,
        "n_inits": args.n_inits,
        "vaf_overall": float(res.vaf),
        "vaf_per_trial": [float(v) for v in res.vaf_per_trial],
        "n_iter": int(res.n_iter),
        "restart_errors": [float(e) for e in res.restart_errors],
    }
    if subjects:
        report["subjects"] = subjects
    names = [str(c) for c in trials[0].coords]  # the EMG channel labels
    if temporal:
        report["temporal_modules"] = (
            res.temporal_modules.to_numpy().tolist()
        )
        report["weights"] = {
            "columns": names,
            "per_capture": np.asarray(res.weights).tolist(),
        }
    else:
        report["spatial_modules"] = {
            "columns": names,
            "rows": res.spatial_modules.to_numpy().tolist(),
        }
        report["activations"] = np.asarray(res.activations).tolist()

    if args.save_model:
        from muscle_synergies_tpu.models import NM3FModel

        kwargs = dict(
            tol=args.tol, max_iter=args.max_iter, n_inits=args.n_inits,
            precision=_cli_precision(args),
        )
        model = (
            NM3FModel.from_temporal_result(res, **kwargs)
            if temporal
            else NM3FModel.from_shared_spatial_result(res, **kwargs)
        )
        print(f"model saved to {model.save(args.save_model)}")

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _analyze_dataset_time_varying(args, trials, fs, config, subjects) -> int:
    """``analyze-dataset --time-varying LAGS``: the convolutive branch."""
    import numpy as np

    import muscle_synergies_tpu as mst

    lo = _validate_time_varying_flags(args)
    try:
        res = mst.analyze_dataset_time_varying(
            trials, fs, n_synergies=lo, n_lags=args.time_varying,
            config=config, max_iter=args.max_iter, tol=args.tol,
            n_inits=args.n_inits, subjects=subjects, impl=args.impl,
            precision=_cli_precision(args),
        )
    except ValueError as exc:
        raise SystemExit(str(exc))

    report = {
        "files": list(args.csvs),
        "sampling_frequency": float(fs),
        "model": "time-varying",
        "lags": args.time_varying,
        "n_inits": args.n_inits,
        "rank": lo,
        "vaf_overall": [float(v) for v in res.vaf_overall],
        "vaf_per_muscle": np.asarray(res.vaf_per_channel).tolist(),
        "n_iter": [int(n) for n in res.n_iter],
        "restart_errors": np.asarray(res.restart_errors).tolist(),
    }
    if subjects:
        report["subjects"] = subjects
        means = res.subject_table("mean")
        report["subject_mean_vaf"] = {
            str(s): float(means[s]) for s in dict.fromkeys(subjects)
        }

    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    import jax

    from muscle_synergies_tpu.utils.platform import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    if args.command == "describe":
        return _cmd_describe(args)
    if args.command == "analyze-dataset":
        return _cmd_analyze_dataset(args)
    if args.command == "export-transform":
        return _cmd_export_transform(args)
    return _cmd_analyze(args)


if __name__ == "__main__":
    sys.exit(main())
