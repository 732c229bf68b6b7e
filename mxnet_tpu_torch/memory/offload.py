"""Host-offloaded optimizer state: momentum / f32 masters in host RAM.

Counterpart of ``mxnet_tpu/memory/offload.py``.  ``Trainer(...,
offload="host")`` keeps the per-parameter optimizer state and
multi-precision masters OFF the card between steps:

- :func:`stash` moves an NDArray's buffer to host memory: on the card
  into a pinned host tensor of its own (made at its first stash and
  reused by every later one), by a ``non_blocking`` copy on a side
  stream that waits for the work queued before it; ``record_stream``
  keeps the device copy alive until the copy has read it.  The pinned
  tensors come from torch's caching host allocator, which rounds each
  block up to a power of two and keeps a dropped block pinned for the
  next pinned allocation of its size.  Without a
  card (CPU runs) the buffer already is host memory and is kept (the
  copy elided), as in the reference.
- :func:`fetch` makes the device copy the update runs on: a
  ``non_blocking`` copy from the pinned buffer on the same side stream
  (so it follows the last stash), which the current stream then waits
  for (``wait_stream``), into ``out`` when given (the trainer's staging
  buffer) or a new tensor.  On the CPU it is a copy, which keeps the
  contract: the update never writes the host-resident original.

The update writes the fetched copies in place; the trainer then stashes
them back into the same pinned buffers.  Host code that reads a stashed
buffer (``save_states``) calls :func:`synchronize` first.  The module
keeps byte counters (``offload_bytes`` in the per-step JSONL rides
:func:`resident_bytes`), and per-step H2D/D2H traffic lands in the
telemetry counters ``offload.h2d_bytes`` / ``offload.d2h_bytes``.
"""
import threading
import weakref

_resident_bytes = 0     # bytes currently parked in host memory
_h2d_total = 0
_d2h_total = 0

_LOCK = threading.Lock()
_HOST = {}   # id(NDArray) -> (weakref to it, its host tensor)
_SIDE = {}   # device index -> the copy stream


def resident_bytes():
    """Optimizer-state bytes currently host-resident (0 when no
    offloading trainer is live)."""
    return _resident_bytes


def stats():
    return {"resident_bytes": _resident_bytes,
            "h2d_bytes_total": _h2d_total, "d2h_bytes_total": _d2h_total}


def _nbytes(raw):
    return raw.numel() * raw.element_size()


def _count(name, n):
    from .. import telemetry

    telemetry.count(name, n)


def _side(device):
    """The side stream that makes every offload copy on ``device``."""
    import torch

    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _LOCK:
        stream = _SIDE.get(index)
        if stream is None:
            stream = _SIDE[index] = torch.cuda.Stream(device=index)
    return stream


def _forget(key):
    with _LOCK:
        _HOST.pop(key, None)


def _host_buffer(arr):
    """The host tensor an NDArray is stashed in (None before its first
    stash)."""
    entry = _HOST.get(id(arr))
    if entry is None or entry[0]() is not arr:
        return None
    return entry[1]


def is_stashed(arr):
    """True while the NDArray's buffer is its host tensor."""
    host = _host_buffer(arr)
    return host is not None and arr._data is host


def stash(arr):
    """Move an NDArray's buffer to host memory in place (D2H, async on
    the card).  Returns the NDArray."""
    global _resident_bytes, _d2h_total
    import torch

    raw = arr._data
    host = _host_buffer(arr)
    if raw.is_cuda:
        if host is None or host.shape != raw.shape or \
                host.dtype != raw.dtype:
            host = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
        side = _side(raw.device)
        side.wait_stream(torch.cuda.current_stream(raw.device))
        with torch.cuda.stream(side):
            host.copy_(raw, non_blocking=True)
        raw.record_stream(side)
    elif host is None:
        host = raw      # already host memory: the copy is elided
    elif host is not raw:
        host.copy_(raw)
    key = id(arr)
    if key not in _HOST:
        weakref.finalize(arr, _forget, key)
    _HOST[key] = (weakref.ref(arr), host)
    arr._data = host
    n = _nbytes(host)
    _resident_bytes += n
    _d2h_total += n
    _count("offload.d2h_bytes", n)
    return arr


def fetch(arr, device=None, out=None):
    """Device copy of a host-stashed NDArray's buffer (H2D, async on the
    card) on ``device`` (default the CPU), into ``out`` when given.
    Returns the raw tensor: the caller rebinds the NDArray to it for the
    in-place update and stashes the result back.  A buffer that is not
    stashed (already on the device) comes back as it is, no copy."""
    global _h2d_total
    import torch

    raw = arr._data
    if not is_stashed(arr):
        return raw
    device = torch.device("cpu" if device is None else device)
    dst = out if out is not None else torch.empty(
        raw.shape, dtype=raw.dtype, device=device)
    if dst.is_cuda:
        side = _side(dst.device)
        current = torch.cuda.current_stream(dst.device)
        side.wait_stream(current)   # dst's memory is free on both streams
        with torch.cuda.stream(side):
            dst.copy_(raw, non_blocking=True)
        current.wait_stream(side)
        if out is None:
            dst.record_stream(side)
    else:
        dst.copy_(raw)
    n = _nbytes(raw)
    _h2d_total += n
    _count("offload.h2d_bytes", n)
    return dst


def release(arr):
    """Book an offloaded NDArray's buffer as no longer host-resident
    (called when a fresh result replaces it)."""
    global _resident_bytes
    _resident_bytes = max(0, _resident_bytes - _nbytes(arr._data))


def synchronize():
    """Wait for every offload copy in flight (before host code reads a
    stashed buffer)."""
    with _LOCK:
        streams = list(_SIDE.values())
    for stream in streams:
        stream.synchronize()


def reset():
    """Drop all counters (tests)."""
    global _resident_bytes, _h2d_total, _d2h_total
    _resident_bytes = _h2d_total = _d2h_total = 0
