"""Binary serialization: MXNet ``.params`` files and module-style
checkpoints.

Counterpart of ``mxnet_tpu/serialization.py`` (reference
``src/ndarray/ndarray.cc`` ``NDArray::Save/Load`` over dmlc::Stream), kept
as the port's own copy.  The container (``mx.nd.save``):

    uint64 kMXAPINDListMagic (0x112)
    uint64 reserved (0)
    uint64 n_arrays; n_arrays x NDArray payload
    uint64 n_names;  n_names x (uint64 len + bytes) names

Per-array payload (dense V2):

    uint32 magic (0xF993FAC9 = V2; V1 = 0xF993FAC8)
    int32  stype (V2 only; 0 = default/dense, 1 = row_sparse, 2 = csr)
    uint32 ndim; ndim x int64 dims          (V1: uint32 dims)
    int32 dev_type; int32 dev_id
    int32 type_flag (mshadow: 0=f32 1=f64 2=f16 3=u8 4=i32 5=i8 6=i64)
    raw little-endian payload

Writes are V2 dense, with bfloat16 written as float32 (as the reference
does), so a file written here is byte for byte the reference's for the
same arrays; reads take V1 and V2 dense.  Row-sparse arrays raise (sparse
storage is ROADMAP Queue 1 item 8).  Loaded arrays lie on the CPU; a
parameter's ``set_data`` copies them to its device.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type flags (reference mshadow/base.h)
_TYPE_FLAG = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
              np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
              np.dtype(np.int32): 4, np.dtype(np.int8): 5,
              np.dtype(np.int64): 6}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


def _host_array(arr):
    """A numpy array of an NDArray, tensor or array-like (bf16 as f32)."""
    if isinstance(arr, np.ndarray):
        return arr
    if isinstance(arr, torch.Tensor):
        arr = NDArray(arr)
    if isinstance(arr, NDArray):
        return arr.asnumpy()
    return np.asarray(arr)


def _ndarray_parts(arr: np.ndarray):
    """The V2 dense payload of ``arr``: (header bytes, contiguous array
    whose raw bytes follow the header)."""
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if arr.dtype not in _TYPE_FLAG:
        raise MXNetError(f"cannot save dtype {arr.dtype} to .params")
    head = struct.pack("<I", _V2_MAGIC)
    head += struct.pack("<i", 0)  # dense stype
    head += struct.pack("<I", arr.ndim)
    head += struct.pack(f"<{arr.ndim}q", *arr.shape)
    head += struct.pack("<ii", 1, 0)  # ctx: cpu(0)
    head += struct.pack("<i", _TYPE_FLAG[arr.dtype])
    return head, np.ascontiguousarray(arr)


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("truncated .params file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_shape(cur, magic):
    ndim = cur.u32()
    if magic == _V2_MAGIC:
        dims = struct.unpack(f"<{ndim}q", cur.take(8 * ndim))
    else:
        dims = struct.unpack(f"<{ndim}I", cur.take(4 * ndim))
    return tuple(int(d) for d in dims)


def _read_dense_body(cur, shape):
    cur.i32()  # dev_type
    cur.i32()  # dev_id
    type_flag = cur.i32()
    if type_flag not in _FLAG_TYPE:
        raise MXNetError(f"unknown dtype flag {type_flag} in .params")
    dtype = _FLAG_TYPE[type_flag]
    count = int(np.prod(shape)) if shape else 1
    data = np.frombuffer(cur.take(count * dtype.itemsize), dtype=dtype)
    return data.reshape(shape)


def _read_ndarray(cur):
    magic = cur.u32()
    if magic not in (_V1_MAGIC, _V2_MAGIC):
        raise MXNetError(f"bad NDArray magic 0x{magic:X} in .params")
    stype = cur.i32() if magic == _V2_MAGIC else 0
    if stype != 0:
        raise MXNetError(
            f"storage type {stype} (row_sparse/csr) in .params: sparse "
            "arrays are not ported yet (ROADMAP.md, Queue 1 item 8)")
    shape = _read_shape(cur, magic)
    return NDArray(torch.from_numpy(np.array(_read_dense_body(cur, shape))))


def save_ndarrays(fname, data):
    """Write the MXNet .params container (a dict or list of NDArrays,
    tensors or numpy arrays)."""
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    with open(fname, "wb") as f:  # streamed: no copy of the whole file
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            head, body = _ndarray_parts(_host_array(arr))
            f.write(head)
            f.write(memoryview(body.reshape(-1)).cast("B"))
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            encoded = name.encode("utf-8")
            f.write(struct.pack("<Q", len(encoded)))
            f.write(encoded)


def load_ndarrays(fname):
    """Read a .params container → a dict (named) or a list (unnamed) of
    NDArrays on the CPU.  Also reads the reference's earlier .npz
    containers."""
    with open(fname, "rb") as f:
        head = f.read(8)
        rest = f.read()
    if head[:4] == b"PK\x03\x04":  # npz zip container
        data = np.load(fname, allow_pickle=False)
        keys = list(data.keys())
        if keys and all(k.startswith("arr_") for k in keys):
            return [NDArray(data[k], ctx=cpu()) for k in
                    sorted(keys, key=lambda s: int(s[4:]))]
        return {k: NDArray(data[k], ctx=cpu()) for k in keys}
    if len(head) < 8:
        raise MXNetError(f"{fname!r} is not an MXNet .params file")
    magic = struct.unpack("<Q", head)[0]
    if magic != _LIST_MAGIC:
        raise MXNetError(
            f"{fname!r} is not an MXNet .params file (magic 0x{magic:X})")
    cur = _Cursor(rest)
    cur.u64()  # reserved
    n = cur.u64()
    arrays = [_read_ndarray(cur) for _ in range(n)]
    n_names = cur.u64()
    if n_names == 0:
        return arrays
    names = [cur.take(cur.u64()).decode("utf-8") for _ in range(n_names)]
    return dict(zip(names, arrays))


def save_checkpoint(prefix, epoch, symbol=None, arg_params=None,
                    aux_params=None):
    """Module-style checkpoint ``prefix-%04d.params`` with ``arg:``/``aux:``
    key prefixes (reference ``mx.model.save_checkpoint``).  A symbol
    raises: the symbol API is ROADMAP Queue 1 item 8."""
    if symbol is not None:
        raise MXNetError("save_checkpoint(symbol=...): the symbol API is "
                         "not ported yet (ROADMAP.md, Queue 1 item 8)")
    payload = {}
    for k, v in (arg_params or {}).items():
        payload[f"arg:{k}"] = v
    for k, v in (aux_params or {}).items():
        payload[f"aux:{k}"] = v
    save_ndarrays(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix, epoch):
    """→ (None, arg_params, aux_params) (reference
    ``mx.model.load_checkpoint``); a ``prefix-symbol.json`` beside the
    file raises, as the symbol API is ROADMAP Queue 1 item 8."""
    if os.path.isfile(f"{prefix}-symbol.json"):
        raise MXNetError(f"{prefix}-symbol.json: the symbol API is not "
                         "ported yet (ROADMAP.md, Queue 1 item 8)")
    loaded = load_ndarrays(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return None, arg_params, aux_params
