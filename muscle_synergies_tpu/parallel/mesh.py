"""Device-mesh construction and sharding helpers.

The framework scales over GPUs through ``jax.sharding``: a mesh with a
``"data"`` axis (trials/subjects) and a ``"time"`` axis (the long EMG
sample dimension — the sequence-parallel axis).  The reference
has no distributed layer at all (SURVEY §2.5); every collective used by
the solvers goes through :mod:`muscle_synergies_tpu.parallel` so the
communication pattern is named, testable on a virtual CPU mesh, and
swappable.

The cards of one host are joined all to all by NVLink, so every pair
of devices talks at the same rate and the mesh shape follows the
algorithm alone; XLA hands the collectives to NCCL.  Multi-host scaling
(several processes, each owning the cards of its host) is entered
through :func:`init_distributed`; after it returns, ``jax.devices()``
spans every process and :func:`make_mesh` lays the global device set
out as usual.  Links between hosts are slower than NVLink, so keep the
heavy (``time``) collectives within a host and lay the
embarrassingly-parallel ``data`` axis across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"
TIME_AXIS = "time"
MODEL_AXIS = "model"

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "MODEL_AXIS",
    "init_distributed",
    "make_mesh",
    "batch_sharding",
    "replicated",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> int:
    """Join this process to a multi-host JAX job.

    Thin, idempotent wrapper over ``jax.distributed.initialize``: call
    once per process before any device query; afterwards
    ``jax.devices()`` returns the *global* device list (all hosts) and
    :func:`make_mesh` builds meshes spanning them — the mesh axes that
    cross hosts communicate over the host network, the axes within a
    host over NVLink (SURVEY §5, distributed-communication-backend
    row).

    All arguments have the ``jax.distributed.initialize`` semantics
    and, like it, fall back to auto-detection from the cluster
    environment when omitted (SLURM, Open MPI).  In a
    plain single-process environment — nothing auto-detectable and no
    coordinator given — this is a no-op, so library code can call it
    unconditionally; repeated calls are no-ops as well.

    Returns:
        the number of participating processes (``jax.process_count()``).
    """
    if jax.distributed.is_initialized():
        return jax.process_count()
    explicit_single = num_processes == 1 and coordinator_address is None
    if not explicit_single:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                **kwargs,
            )
        except RuntimeError as exc:
            # Two benign shapes: a concurrent/second initializer (jax
            # 0.9 wording: "should only be called once"), and an
            # argless call after the XLA backend is already up on a
            # plain single host — a library caller probing for a
            # cluster.  A late call that was *explicitly configured*
            # (any argument) or that runs where a cluster environment
            # is advertised stays an error: swallowing it would
            # silently degrade a multi-host job to N independent
            # single-process runs.
            msg = str(exc).lower()
            explicit = (
                coordinator_address is not None
                or num_processes is not None
                or process_id is not None
                or bool(kwargs)
            )
            benign = (
                "only be called once" in msg
                or "already" in msg
                or (
                    "before any jax calls" in msg
                    and not explicit
                    and not _cluster_env_configured()
                )
            )
            if not benign:
                raise
        except ValueError as exc:
            # auto-detection found no cluster: single-process no-op —
            # but surface the error when the caller asked for one
            if (
                coordinator_address is not None
                or num_processes is not None
                or "coordinator_address" not in str(exc)
            ):
                raise
    return jax.process_count()


def _cluster_env_configured() -> bool:
    """True when the environment advertises a *multi-process* cluster.

    Single-worker values (one-task SLURM/MPI jobs) do not count: only evidence of >1 process should turn a
    late ``init_distributed()`` into a hard error.
    """
    import os

    if any(
        os.environ.get(var)
        for var in (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
        )
    ):
        return True
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        val = os.environ.get(var, "")
        if val.isdigit() and int(val) > 1:
            return True
    return False


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = (DATA_AXIS, TIME_AXIS),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2-D ``(data, time)`` mesh over the available devices.

    Args:
        shape: ``(n_data, n_time)``; defaults to all devices on the
            data axis (pure data parallelism).  Either entry may be
            ``-1`` to infer it from the device count (so
            ``make_mesh((-1, 2))`` works on any even-sized slice).
        axis_names: names for the two axes.
        devices: devices to use (defaults to ``jax.devices()``, which
            spans every process after :func:`init_distributed`).
    """
    if devices is None:
        devices = jax.devices()
    n_avail = len(devices)
    if shape is None:
        shape = (n_avail, 1)
    n_data, n_time = shape
    if n_data == -1 and n_time == -1:
        raise ValueError("at most one mesh axis may be -1")
    if n_data == -1 or n_time == -1:
        known = n_time if n_data == -1 else n_data
        if known <= 0 or n_avail % known != 0:
            raise ValueError(
                f"cannot infer mesh shape {shape}: {n_avail} devices "
                f"do not split evenly by {known}"
            )
        n_data, n_time = (
            (n_avail // known, known) if n_data == -1 else (known, n_avail // known)
        )
    if n_data * n_time != n_avail:
        raise ValueError(
            f"mesh shape {(n_data, n_time)} needs {n_data * n_time} "
            f"devices, got {n_avail}. Pass shape=(-1, n) to fit the "
            "available devices, or provision virtual CPU devices with "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N (set "
            "before the first device query) plus "
            'jax.config.update("jax_platforms", "cpu").'
        )
    grid = np.asarray(devices).reshape(n_data, n_time)
    return Mesh(grid, axis_names)


def batch_sharding(mesh: Mesh, time_sharded: bool = False) -> NamedSharding:
    """Sharding for a ``(B, N, L)`` trial batch.

    Trials spread over the ``data`` axis; with ``time_sharded`` the
    sample axis additionally splits over the ``time`` axis (sequence
    parallelism).
    """
    spec = PartitionSpec(
        DATA_AXIS, TIME_AXIS if time_sharded else None, None
    )
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding on the mesh."""
    return NamedSharding(mesh, PartitionSpec())
