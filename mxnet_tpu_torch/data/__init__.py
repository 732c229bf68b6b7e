"""The streaming data plane: sharded elastic readers, host-to-device
prefetch on a CUDA stream, and sequence packing.

Counterpart of ``mxnet_tpu/data``:

    ShardedRecordReader ──► StreamingLoader ──► DevicePrefetcher ──► step
        (.rec/.idx,             (decode workers,      (pinned copy on a
         elastic draw)           optional packing)     stream of its own)

Everything is keyed on the global training step: the reader's sample draw
is a pure function of ``(seed, step)`` through ``elastic``, so the
checkpointed step determines the pipeline position at any world size.
"""
from .reader import ShardedRecordReader
from .packing import (PackedBatch, PackingStats, SequencePacker,
                      pack_documents)
from .prefetch import DevicePrefetcher
from .pipeline import StreamingLoader

__all__ = ["ShardedRecordReader", "StreamingLoader", "DevicePrefetcher",
           "SequencePacker", "PackedBatch", "PackingStats",
           "pack_documents"]
