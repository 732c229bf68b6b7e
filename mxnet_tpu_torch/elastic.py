"""Elastic data-parallel resize: deterministic shard assignment.

Counterpart of ``mxnet_tpu/elastic.py``, kept as the port's own copy: the
data a rank trains on is a pure function of ``(seed, step)`` and the
current world size, so a job can shrink or grow between checkpoints
without changing the math.

- ``global_batch_indices``: the step's global batch, identical at every
  world size (a numpy generator per ``(seed, step)``);
- ``shard_indices``/``shard_for_step``/``shard_rows``: each rank's
  contiguous slice of it (the global batch divides evenly);
- nothing is stateful: the checkpointed step is the data position.
"""
from __future__ import annotations

import os

import numpy as np

from .base import MXNetError

__all__ = ["global_batch_indices", "shard_indices", "shard_for_step",
           "shard_rows", "world_info"]


def _step_rng(seed, step):
    """An independent numpy Generator per (seed, step).

    ``SeedSequence(seed).spawn`` semantics via ``spawn_key``: streams for
    different steps are statistically independent, and the mapping is a
    stable function of the two integers (no global RNG state involved —
    an elastic restart cannot perturb it)."""
    seed = int(seed)
    step = int(step)
    if step < 0:
        raise MXNetError(f"step must be >= 0, got {step}")
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(entropy=seed, spawn_key=(step,))))


def global_batch_indices(dataset_size, batch_size, step, seed=0,
                         shuffle=True):
    """The step's GLOBAL batch as dataset indices — a pure function of
    ``(seed, step)``, identical at every world size.

    ``shuffle=True`` (default) draws ``batch_size`` distinct indices per
    step (sampling without replacement within the batch, fresh per
    step); ``shuffle=False`` walks the dataset sequentially with
    wraparound, the classic epoch order."""
    dataset_size = int(dataset_size)
    batch_size = int(batch_size)
    if batch_size <= 0 or dataset_size <= 0:
        raise MXNetError("dataset_size and batch_size must be positive")
    if not shuffle:
        start = int(step) * batch_size
        return (start + np.arange(batch_size)) % dataset_size
    if batch_size > dataset_size:
        raise MXNetError(
            f"batch_size {batch_size} > dataset_size {dataset_size} "
            "(shuffle=True samples without replacement within a batch)")
    return _step_rng(seed, step).choice(dataset_size, size=batch_size,
                                        replace=False)


def shard_indices(indices, world_size, rank):
    """This rank's contiguous slice of a global batch.

    The global batch size must divide evenly by ``world_size`` so every
    resize keeps ``trainer.step(global_batch)`` normalization exact —
    elastic jobs pick a global batch divisible by every world size they
    may run at (e.g. a multiple of the max)."""
    world_size = int(world_size)
    rank = int(rank)
    if not 0 <= rank < world_size:
        raise MXNetError(f"rank {rank} out of range for world {world_size}")
    n = len(indices)
    if n % world_size:
        raise MXNetError(
            f"global batch of {n} does not divide evenly over "
            f"{world_size} workers — elastic resize would change the "
            "per-step math; pick a global batch divisible by every "
            "world size the job may run at")
    per = n // world_size
    return indices[rank * per:(rank + 1) * per]


def shard_for_step(dataset_size, batch_size, step, world_size, rank,
                   seed=0, shuffle=True):
    """``shard_indices(global_batch_indices(...))`` in one call — the
    per-step data assignment an elastic training loop feeds its rank."""
    return shard_indices(
        global_batch_indices(dataset_size, batch_size, step, seed=seed,
                             shuffle=shuffle),
        world_size, rank)


def shard_rows(num_rows, world_size, rank):
    """This rank's contiguous row slice of a batch assembled globally.

    The packed-batch analogue of ``shard_indices``: when every rank
    deterministically builds the same global ``(num_rows, ...)`` batch
    (e.g. ``data.SequencePacker`` packing a step's global document
    draw), each rank keeps rows ``shard_rows(num_rows, world, rank)``.
    Same divisibility contract, same resize invariance — the union of
    all ranks' rows is the identical global batch at every world size.
    """
    return shard_indices(np.arange(int(num_rows)), world_size, rank)


def world_info():
    """``(rank, world_size)`` of this process: the launcher's
    process group's when ``parallel.initialize`` formed one, else the
    launcher's ``MXT_PROCESS_ID``/``MXT_NUM_PROCESSES``, else ``(0, 1)``
    (the reference asks its process group first)."""
    from . import parallel

    if parallel.is_initialized():
        return parallel.rank(), parallel.world_size()
    return (int(os.environ.get("MXT_PROCESS_ID", "0")),
            int(os.environ.get("MXT_NUM_PROCESSES", "1")))
