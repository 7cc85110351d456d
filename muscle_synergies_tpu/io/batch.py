"""Trial batching and host->device feeding.

Bridges the ingest layer to the batched solvers: ragged trials become
padded ``(B, N, L)`` device arrays with masks, placed under an explicit
sharding, and an asynchronous prefetcher overlaps host preprocessing /
transfers with device compute (the pipeline-parallelism analog for this
workload — SURVEY §2.5 maps the reference's absent PP row to exactly
this ingest->preprocess->factorize pipelining).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.batch import pad_and_stack

__all__ = ["TrialBatch", "stack_trials", "batch_iterator", "device_prefetch"]


@dataclass
class TrialBatch:
    """A padded batch of trials ready for the batched solvers.

    Attributes:
        data: ``(B, N, L)`` padded measurements.
        mask: ``(B, N)`` validity mask (1 = real sample).
        lengths: original per-trial lengths.
        names: optional per-trial identifiers.
    """

    data: jnp.ndarray
    mask: jnp.ndarray
    lengths: np.ndarray
    names: Optional[List[str]] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]


def stack_trials(
    trials: Sequence[np.ndarray],
    pad_to: Optional[int] = None,
    names: Optional[Sequence[str]] = None,
    sharding=None,
    dtype=None,
) -> TrialBatch:
    """Pad/stack ragged trials and place them on device.

    Args:
        trials: ``(N_i, L)`` arrays sharing the channel count.
        pad_to: pad every trial to this length (defaults to the max).
        sharding: optional ``jax.sharding.Sharding`` for the batch.
        dtype: cast target (e.g. ``jnp.float32`` for accelerator runs).
    """
    if names is not None and len(names) != len(trials):
        raise ValueError(f"got {len(names)} names for {len(trials)} trials")
    data, mask = pad_and_stack(trials, pad_to=pad_to)
    if dtype is not None:
        data = data.astype(dtype)
        mask = mask.astype(dtype)
    if sharding is not None:
        data = jax.device_put(data, sharding)
        mask = jax.device_put(mask, sharding)
    else:
        data = jnp.asarray(data)
        mask = jnp.asarray(mask)
    return TrialBatch(
        data=data,
        mask=mask,
        lengths=np.array([t.shape[0] for t in trials]),
        names=list(names) if names is not None else None,
    )


def batch_iterator(
    trials: Sequence[np.ndarray],
    batch_size: int,
    pad_to: Optional[int] = None,
    drop_remainder: bool = False,
    names: Optional[Sequence] = None,
    **stack_kwargs,
) -> Iterator[TrialBatch]:
    """Yield :class:`TrialBatch` chunks of ``batch_size`` trials.

    ``names`` (one per trial) is sliced alongside the trials so every
    batch's ``names[i]`` labels its own ``data[i]``.
    """
    if names is not None and len(names) != len(trials):
        raise ValueError(
            f"got {len(names)} names for {len(trials)} trials"
        )
    if pad_to is None:
        pad_to = max(t.shape[0] for t in trials)
    for start in range(0, len(trials), batch_size):
        chunk = trials[start : start + batch_size]
        if drop_remainder and len(chunk) < batch_size:
            return
        chunk_names = (
            names[start : start + batch_size] if names is not None else None
        )
        yield stack_trials(
            chunk, pad_to=pad_to, names=chunk_names, **stack_kwargs
        )


def device_prefetch(
    iterable: Iterable,
    buffer_size: int = 2,
    sharding=None,
) -> Iterator:
    """Asynchronously stage upcoming items onto device.

    A background thread pulls from ``iterable`` and issues
    ``device_put`` (async under JAX) for up to ``buffer_size`` items
    ahead of the consumer, so host-side parsing/padding and the PCIe/
    ICI transfer overlap with device compute on the current batch.
    """
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END = object()
    _ERROR = object()

    def put(item):
        if sharding is not None:
            return jax.tree_util.tree_map(
                lambda a: jax.device_put(a, sharding)
                if isinstance(a, (np.ndarray, jnp.ndarray))
                else a,
                item,
            )
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a)
            if isinstance(a, (np.ndarray, jnp.ndarray))
            else a,
            item,
        )

    stop = threading.Event()

    def offer(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not offer(put(item)):
                    return  # consumer abandoned the generator
        except BaseException as exc:  # propagate to the consumer
            offer((_ERROR, exc))
        else:
            offer(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if (
                isinstance(item, tuple)
                and len(item) == 2
                and item[0] is _ERROR
            ):
                raise item[1]
            yield item
    finally:
        # unblock the producer on early exit (break / GeneratorExit) so
        # it releases the upstream iterator's resources
        stop.set()
