"""Asynchronous parameter-server KVStore (``dist_async``).

Counterpart of ``mxnet_tpu/kvstore/dist_async.py`` (reference
``src/kvstore/kvstore_dist.h`` and ``kvstore_dist_server.h``): workers
push without a barrier, and the server applies the optimizer to each
gradient as it arrives.  Each worker's own pushes stay in order a key;
staleness across workers is the accepted trade.

The server's table lives on the server process's device: its card when
it has one, the CPU only when it has none (``PSServer(device=)``).  The
update runs there through the optimizer's own route, the fused
multi-tensor kernel where its rule applies (``Updater.update_many``,
``gluon.Trainer``'s update).  Only the wire's bytes pass through host
memory; the in-process form never leaves the device.  A worker copies
each pulled value into its target where the target lives.

- In-process form (no ``MXT_PS_ROOT_URI``): a dispatcher thread drains a
  FIFO and applies it to a local table, the pushes queued together (to
  distinct keys) in one update.  ``push`` returns at once; an error of a
  queued push is raised at the next sync point (``pull``, ``wait_all``,
  ``init``, ``set_optimizer``, the next ``push``).
- Cross-process form: a TCP server thread (``serve_forever``, on rank 0
  or its own process) holds the table; workers connect to
  ``MXT_PS_ROOT_URI`` (``host:port``).

The wire is the reference's, byte for byte, so a worker of either package
talks to a server of the other: ``u64 len | sig[32] | u32 hlen |
header_json | bufs``, the header a JSON tree with each array replaced by
``{"__a__": index, "dtype", "shape"}`` and nothing executable in a frame.
bfloat16 (which numpy lacks without ``ml_dtypes``) crosses as its raw
16-bit words under the dtype name ``"bfloat16"``, the reference's
layout.  With ``MXT_PS_SECRET`` set, the server challenges each
connection (a nonce and an HMAC response, under a timeout) before it
reads a frame, and every frame is signed with HMAC-SHA256 over the
connection nonce, the direction (``b"C"`` worker to server, ``b"S"``
replies), a per-direction sequence number and the body; the one pickled
payload, ``set_optimizer``, is refused over an unsigned connection.

Row-sparse values cross the wire both ways in the reference's form,
``("row_sparse", data, indices, shape)``: a pushed ``RowSparseNDArray``
reaches the server's optimizer as one (its lazy row update), and
``row_sparse_pull`` asks for the rows it needs (``("rows", values,
ids)`` back).  Telemetry, as the local store's: the ``kvstore.push`` and
``kvstore.pull`` spans and the ``kvstore.push_bytes`` /
``kvstore.pull_bytes`` counters (a row-sparse push counts its rows and
indices, ``row_sparse_pull`` the rows that came over the wire).
"""
from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import pickle
import queue
import socket
import socketserver
import struct
import threading

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import sparse as sp
from . import _dense

__all__ = ["AsyncPSKVStore", "PSServer", "serve_forever"]

_SECRET_ENV = "MXT_PS_SECRET"
_ENV_SECRET = object()  # sentinel: "default to the MXT_PS_SECRET env var"
_MAX_FRAME = 1 << 33  # 8 GiB sanity cap on a single frame
_SAFE_DTYPES = frozenset([
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "bfloat16",
    "complex64", "complex128",
])
_NOTHING = object()  # the dispatcher holds no message


def _secret():
    s = os.environ.get(_SECRET_ENV)
    return s.encode() if s else None


def _as_secret(secret):
    if secret is _ENV_SECRET:
        return _secret()
    return secret.encode() if isinstance(secret, str) else secret


# --- wire helpers -----------------------------------------------------------
#
# Frame layout (all little-endian):
#   u64 payload_len | sig[32] | u32 header_len | header_json | buf0 buf1 ...
# header_json = {"t": tree, "n": [buf nbytes...]}, the tree mirroring the
# message with each array or bytes object replaced by an {"__a__"/"__r__":
# buf_index} marker.  sig = HMAC-SHA256(secret, nonce || direction ||
# u64 seq || body), or 32 zero bytes without a secret.

def _raw(a):
    """The bytes of a contiguous numpy array, as a view (no copy)."""
    return memoryview(a.reshape(-1).view(np.uint8))


def _array_bytes(o):
    """(dtype name, shape, raw bytes) of an array: a torch tensor on any
    device (copied to the host; a bf16 one as its 16-bit words) or a
    numpy array."""
    if isinstance(o, torch.Tensor):
        t = o.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _SAFE_DTYPES:
            raise MXNetError(f"non-wireable dtype {t.dtype}")
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return name, list(t.shape), _raw(words.numpy())
    a = np.ascontiguousarray(o)
    if str(a.dtype) not in _SAFE_DTYPES:
        raise MXNetError(f"non-wireable dtype {a.dtype}")
    return str(a.dtype), list(a.shape), _raw(a)


def _encode_obj(o, bufs):
    if isinstance(o, (np.ndarray, torch.Tensor)):
        dtype, shape, raw = _array_bytes(o)
        bufs.append(raw)
        return {"__a__": len(bufs) - 1, "dtype": dtype, "shape": shape}
    if isinstance(o, (bytes, bytearray)):
        bufs.append(bytes(o))
        return {"__r__": len(bufs) - 1}
    if isinstance(o, (tuple, list)):
        return [_encode_obj(x, bufs) for x in o]
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if o is None or isinstance(o, (bool, int, float, str)):
        return o
    raise MXNetError(f"non-wireable object of type {type(o).__name__}")


def _decode_array(raw, dtype, shape):
    """A wire array as a host torch tensor over the received frame's
    memory (copied only where that memory is read-only or misaligned)."""
    if dtype not in _SAFE_DTYPES:
        raise MXNetError(f"refusing wire dtype {dtype!r}")
    a = np.frombuffer(raw, np.int16 if dtype == "bfloat16"
                      else np.dtype(dtype)).reshape(shape)
    if not a.flags.writeable or a.ctypes.data % max(1, a.itemsize):
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _decode_obj(o, bufs):
    if isinstance(o, dict):
        if "__a__" in o:
            return _decode_array(bufs[o["__a__"]], o["dtype"], o["shape"])
        if "__r__" in o:
            return bytes(bufs[o["__r__"]])
        raise MXNetError("malformed wire header")
    if isinstance(o, list):
        return tuple(_decode_obj(x, bufs) for x in o)
    return o


def _mac(secret, nonce, direction, seq, *body):
    """The signature binds the connection nonce, the direction and the
    per-direction sequence number: a recorded frame cannot be replayed
    into the same or another stream, nor reflected back.  ``body`` may
    come in pieces (HMAC over their concatenation, which is not made)."""
    mac = hmac.new(secret, bytes(nonce) + direction + struct.pack("<Q", seq),
                   hashlib.sha256)
    for piece in body:
        mac.update(piece)
    return mac.digest()


def _pack_frame(msg, secret, nonce=b"", direction=b"", seq=0):
    bufs = []
    tree = _encode_obj(msg, bufs)
    header = json.dumps({"t": tree, "n": [len(b) for b in bufs]},
                        separators=(",", ":")).encode()
    body = [struct.pack("<I", len(header)), header, *bufs]
    sig = _mac(secret, nonce, direction, seq, *body) if secret \
        else b"\x00" * 32
    size = 32 + sum(len(b) for b in body)
    return b"".join([struct.pack("<Q", size), sig, *body])


def _unpack_frame(payload, secret, nonce=b"", direction=b"", seq=0):
    """→ (msg, signed): ``signed`` is True when a secret is set and the
    signature verifies; with a secret a bad signature raises.  The
    arrays of the message share ``payload``'s memory."""
    payload = memoryview(payload)
    sig, body = bytes(payload[:32]), payload[32:]
    signed = False
    if secret is not None:
        if not hmac.compare_digest(
                _mac(secret, nonce, direction, seq, body), sig):
            raise MXNetError("PS frame signature mismatch (MXT_PS_SECRET "
                             "differs between peers, or a replayed/"
                             "out-of-order frame)")
        signed = True
    try:
        (hlen,) = struct.unpack("<I", body[:4])
        header = json.loads(bytes(body[4:4 + hlen]).decode())
        bufs, off = [], 4 + hlen
        for n in header["n"]:
            bufs.append(body[off:off + n])
            off += n
        return _decode_obj(header["t"], bufs), signed
    except MXNetError:
        raise
    except Exception as e:  # malformed header or buffers: one error type
        raise MXNetError(f"malformed PS frame: {e!r}")


def _recv_exact(sock, n):
    """``n`` bytes from ``sock``, received into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _no_delay(sock):
    """Frames are written whole: send each at once (no Nagle wait for
    the peer's delayed acknowledgement of the previous one)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _FrameChannel:
    """Framed duplex channel over a connected socket, with per-direction
    sequence-numbered signatures when a secret is set."""

    def __init__(self, sock, secret, nonce, is_server):
        self._sock = sock
        self._secret = secret
        self._nonce = nonce
        self._tx_dir = b"S" if is_server else b"C"
        self._rx_dir = b"C" if is_server else b"S"
        self._tx_seq = 0
        self._rx_seq = 0

    def send(self, obj):
        payload = _pack_frame(obj, self._secret, self._nonce,
                              self._tx_dir, self._tx_seq)
        self._tx_seq += 1
        self._sock.sendall(payload)

    def recv(self):
        (n,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
        if not 32 <= n <= _MAX_FRAME:
            raise MXNetError(f"bad PS frame length {n}")
        msg, signed = _unpack_frame(_recv_exact(self._sock, n),
                                    self._secret, self._nonce,
                                    self._rx_dir, self._rx_seq)
        self._rx_seq += 1
        return msg, signed


def _snapshot(t):
    """A copy of a tensor's global value on its own device (a DTensor's
    whole array): a queued push must not see later writes to its source,
    and the table must not share a worker's storage."""
    from ..parallel.local import is_dtensor

    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().clone(memory_format=torch.contiguous_format)


def _to_wire(v):
    """A value as the wire's ``("dense", array)`` or ``("row_sparse",
    data, indices, shape)``; the arrays stay on their device until a
    frame is packed (``_array_bytes``)."""
    if isinstance(v, sp.RowSparseNDArray):
        return ("row_sparse", _snapshot(v.data._data),
                _snapshot(v.indices._data), tuple(v.shape))
    if isinstance(v, NDArray):
        return ("dense", _snapshot(v._data))
    if isinstance(v, torch.Tensor):
        return ("dense", _snapshot(v))
    return ("dense", np.asarray(v))


def _tensor(v, device=None):
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return v if device is None else v.to(device)


def _from_wire(w, device=None):
    """A wire value as an NDArray or a ``RowSparseNDArray``, on
    ``device`` (default: where it lies)."""
    if w[0] == "row_sparse":
        _, data, idx, shape = w
        return sp.RowSparseNDArray(NDArray(_tensor(data, device)),
                                   _tensor(idx, device), shape)
    if w[0] != "dense":
        raise MXNetError(f"unknown wire value kind {w[0]!r}")
    return NDArray(_tensor(w[1], device))


def _first_target(o):
    return o[0] if isinstance(o, (list, tuple)) else o


def _ready(wire):
    """An event recorded after a value's snapshot on its card (None for a
    host value): the thread that sends or applies it waits for it, so the
    push is ordered after the snapshot on whatever stream made it."""
    v = wire[1]
    if not (isinstance(v, torch.Tensor) and v.is_cuda):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(v.device))
    return ev


def _server_device():
    """This process's card when it has one, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --- the server table -------------------------------------------------------

class PSServer:
    """The parameter table and the asynchronous updater (reference
    ``kvstore_dist_server.h``, its dist_async branch: each update applied
    on arrival, no wait for other workers).  The table lives on
    ``device`` (default: this process's card, the CPU without one), as
    the reference's server keeps its NDArrays on its default device."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None \
            else _server_device()
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._lock = threading.Lock()

    def set_optimizer_bytes(self, opt_bytes):
        from .. import optimizer as opt_mod

        opt = pickle.loads(opt_bytes)
        with self._lock:
            self._optimizer = opt
            self._updater = opt_mod.get_updater(opt)

    def push_many(self, keys, wires):
        """Apply pushes to distinct keys: through the optimizer, in one
        update, or (without one) the pushed values replace the stored
        ones, as the local store and the reference's server do."""
        grads = [_from_wire(w, self.device) for w in wires]
        with self._lock:
            for k in keys:
                if k not in self._store:
                    raise MXNetError(f"key {k!r} not initialized")
            if self._updater is None:
                # the pushed values replace the stored ones, dense (the
                # reference's server)
                self._store.update(zip(keys, map(_dense, grads)))
                return
            self._updater.update_many(
                [int(k) if k.isdigit() else k for k in keys], grads,
                [self._store[k] for k in keys])

    def handle(self, cmd, *args, trusted=True):
        """``trusted=False`` marks a request that came over TCP without a
        verified HMAC: the data commands run, the pickled optimizer is
        refused."""
        if cmd == "init":
            k, w = args
            with self._lock:
                if k not in self._store:
                    self._store[k] = _from_wire(w, self.device)
            return None
        if cmd == "push":
            k, w = args
            self.push_many([k], [w])
            return None
        if cmd == "pull":
            (k,) = args
            with self._lock:
                if k not in self._store:
                    raise MXNetError(f"key {k!r} not initialized")
                return _to_wire(self._store[k])
        if cmd == "row_sparse_pull":
            k, rows = args
            with self._lock:
                if k not in self._store:
                    raise MXNetError(f"key {k!r} not initialized")
                dense = _dense(self._store[k])._data
                ids = sp._index_tensor(rows, dense.device)
                return ("rows", dense[ids], ids)
        if cmd == "set_optimizer":
            if not trusted:
                raise MXNetError(
                    "set_optimizer over TCP requires HMAC-signed frames: "
                    "set the MXT_PS_SECRET shared secret on server and "
                    "workers (python -m mxnet_tpu_torch.launch generates "
                    "one per job)")
            (ob,) = args
            self.set_optimizer_bytes(ob)
            return None
        if cmd == "set_hparams":
            # a refresh of lr / rescale_grad / wd that keeps the server's
            # optimizer state (a new set_optimizer would reset it)
            lr, rescale, wd = args
            with self._lock:
                if self._optimizer is None:
                    raise MXNetError("set_hparams before set_optimizer")
                if lr is not None:
                    if self._optimizer.lr_scheduler is not None:
                        # the worker ships an explicit lr only when its own
                        # optimizer has no scheduler: follow it
                        logging.warning(
                            "PS set_hparams: explicit lr=%s overrides "
                            "the server-side lr_scheduler (dropped to "
                            "match the worker's optimizer)", lr)
                        self._optimizer.lr_scheduler = None
                    self._optimizer.lr = lr
                if rescale is not None:
                    self._optimizer.rescale_grad = rescale
                if wd is not None:
                    self._optimizer.wd = wd
            return None
        if cmd == "barrier":
            return None  # each connection is a FIFO: a flush marker
        raise MXNetError(f"unknown PS command {cmd!r}")


_AUTH_TAG = b"mxt-ps-auth"


def _auth_response(secret, nonce):
    return hmac.new(secret, _AUTH_TAG + nonce, hashlib.sha256).digest()


class _PSRequestHandler(socketserver.BaseRequestHandler):
    def handle(self):
        secret = self.server.secret
        # hello: 1 flag byte (authentication required?) + a 16-byte nonce.
        # With a secret the peer answers the challenge before any frame is
        # read, under a timeout: an unauthenticated peer is dropped after
        # a 32-byte read and never makes the server buffer a large frame
        nonce = os.urandom(16)
        _no_delay(self.request)
        self.request.sendall((b"\x01" if secret else b"\x00") + nonce)
        if secret:
            self.request.settimeout(30)
            try:
                resp = _recv_exact(self.request, 32)
            except (ConnectionError, OSError):
                return
            if not hmac.compare_digest(resp, _auth_response(secret, nonce)):
                return
            self.request.settimeout(None)  # workers idle legitimately
        chan = _FrameChannel(self.request, secret, nonce, is_server=True)
        while True:
            try:
                msg, signed = chan.recv()
            except (ConnectionError, OSError, struct.error, MXNetError):
                return  # torn, malformed or forged frame: drop the peer
            if msg[0] == "bye":
                return
            try:
                reply = ("ok", self.server.ps.handle(msg[0], *msg[1:],
                                                     trusted=signed))
            except Exception as e:  # the error crosses the wire
                reply = ("err", repr(e))
            try:
                chan.send(reply)
            except OSError:
                return


class _PSTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_forever(uri, ps=None, background=True, secret=_ENV_SECRET):
    """Start the parameter server on ``uri`` (``"host:port"``) and return
    it (``.shutdown()`` stops it; ``.server_close()`` frees the port).
    ``secret`` defaults to ``MXT_PS_SECRET`` read now; ``None`` runs
    unauthenticated."""
    host, port = uri.rsplit(":", 1)
    srv = _PSTCPServer((host, int(port)), _PSRequestHandler)
    srv.ps = ps or PSServer()
    srv.secret = _as_secret(secret)
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mxt-ps-server").start()
    else:
        srv.serve_forever()
    return srv


# --- the worker-side store --------------------------------------------------

class AsyncPSKVStore:
    """The ``dist_async`` worker store.

    Without ``MXT_PS_ROOT_URI`` (or ``root_uri``) it serves itself: a
    dispatcher thread and a local table.  With one, frames go to that
    server; the sender thread keeps this worker's pushes in order while
    ``push`` returns at once."""

    def __init__(self, root_uri=None, rank=None, num_workers=None,
                 secret=_ENV_SECRET):
        self.type = "dist_async"
        self._rank = int(rank if rank is not None
                         else os.environ.get("MXT_RANK", 0))
        self._num_workers = int(num_workers if num_workers is not None
                                else os.environ.get("MXT_NWORKER", 1))
        self._uri = root_uri or os.environ.get("MXT_PS_ROOT_URI")
        self._wire_secret = _as_secret(secret)
        self._queue = queue.Queue()
        self._err = None
        self._local = None
        self._sock = None
        self._sock_lock = threading.Lock()
        self._compression = None
        self._residuals = {}
        self.updates_on_server = False  # set_optimizer was called
        if self._uri:
            self._connect()
        else:
            self._local = PSServer()
        self._sender = threading.Thread(target=self._drain, daemon=True,
                                        name="mxt-ps-sender")
        self._sender.start()

    def _connect(self):
        host, port = self._uri.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=60)
        try:
            _no_delay(self._sock)
            hello = bytes(_recv_exact(self._sock, 17))
            if hello[:1] == b"\x01":  # the server challenges
                if self._wire_secret is None:
                    raise MXNetError(
                        "PS server requires authentication: set the "
                        "MXT_PS_SECRET shared secret (python -m "
                        "mxnet_tpu_torch.launch generates one per job)")
                self._sock.sendall(
                    _auth_response(self._wire_secret, hello[1:]))
            elif self._wire_secret is not None:
                raise MXNetError(
                    "this worker has MXT_PS_SECRET but the PS server "
                    f"at {self._uri} runs UNAUTHENTICATED — restart "
                    "the server with the same shared secret")
            self._sock.settimeout(None)
        except BaseException:
            self._sock.close()  # no leaked connection on a failed hello
            self._sock = None
            raise
        self._chan = _FrameChannel(self._sock, self._wire_secret, hello[1:],
                                   is_server=False)

    # -- identity -----------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    # -- dispatcher ----------------------------------------------------------
    def _rpc(self, *msg):
        """One synchronous round trip (the sender thread's, and pulls')."""
        if self._local is not None:
            return self._local.handle(msg[0], *msg[1:])
        with self._sock_lock:
            self._chan.send(msg)
            (status, payload), _ = self._chan.recv()
        if status == "err":
            raise MXNetError(f"PS server error: {payload}")
        return payload

    def _drain(self):
        held = _NOTHING
        while True:
            msg, ready = self._queue.get() if held is _NOTHING else held
            held = _NOTHING
            if msg is None:
                self._queue.task_done()
                return
            batch = [(msg, ready)]
            if self._local is not None and msg[0] == "push":
                # the pushes queued behind this one, to other keys, go
                # into the same update
                keys = {msg[1]}
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt[0] is None or nxt[0][0] != "push" or \
                            nxt[0][1] in keys:
                        held = nxt
                        break
                    keys.add(nxt[0][1])
                    batch.append(nxt)
            try:
                for _, ev in batch:
                    if ev is not None:
                        ev.synchronize()
                if len(batch) > 1:
                    self._local.push_many([m[1] for m, _ in batch],
                                          [m[2] for m, _ in batch])
                else:
                    self._rpc(*msg)
                if self._local is not None and \
                        self._local.device.type == "cuda":
                    # a pull on another stream sees the finished update
                    torch.cuda.current_stream(
                        self._local.device).synchronize()
            except Exception as e:  # raised at the next sync point
                self._err = e
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _enqueue(self, *msg):
        self._raise_pending()
        self._queue.put((msg, _ready(msg[2]) if msg[0] == "push"
                         else None))

    def wait_all(self):
        """Wait for every queued push (the ``Engine::WaitForAll`` of the
        store); a queued push's error is raised here."""
        self._queue.join()
        self._raise_pending()

    # -- core ops ------------------------------------------------------------
    @staticmethod
    def _key(key):
        return str(key)

    def init(self, key, value):
        from . import _pairs

        self.wait_all()  # control calls keep program order with pushes
        for k, v in zip(*_pairs(key, value)):
            self._rpc("init", self._key(k), _to_wire(v))

    def push(self, key, value, priority=0):
        """Queue the value(s) and return (the asynchronous contract); a
        list pushed to one key is summed first."""
        from . import _merge, _pairs

        with telemetry.span("kvstore.push"):
            keys, values = _pairs(key, value)
            if telemetry.is_enabled():
                telemetry.count("kvstore.push_bytes",
                                sum(telemetry.nbytes_of(v) for v in values))
            for k, v in zip(keys, values):
                merged = _merge(v)
                if self._compression is not None:
                    merged, self._residuals[self._key(k)] = \
                        self._compression.roundtrip(
                            _dense(merged),
                            self._residuals.get(self._key(k)))
                self._enqueue("push", self._key(k), _to_wire(merged))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Blocking: reflects this worker's pushes (each worker's FIFO),
        maybe not other workers' yet.  Each target gets the value copied
        in place, on its own device and in its own dtype."""
        from ..parallel.local import copy_global_into
        from . import _pairs

        with telemetry.span("kvstore.pull"):
            self.wait_all()
            keys, outs = _pairs(key, out)
            if telemetry.is_enabled():
                telemetry.count("kvstore.pull_bytes",
                                sum(telemetry.nbytes_of(o) for o in outs))
            for k, o in zip(keys, outs):
                stored = _dense(_from_wire(
                    self._rpc("pull", self._key(k))))._data
                for target in (o if isinstance(o, (list, tuple)) else [o]):
                    copy_global_into(target._data, stored.to(target.dtype))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Blocking, as ``pull``: only the rows ``row_ids`` come over the
        wire; a ``RowSparseNDArray`` target gets them, a dense target has
        just those rows written in place."""
        from . import _pairs, write_rows

        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        with telemetry.span("kvstore.pull"):
            self.wait_all()
            keys, outs = _pairs(key, out)
            rids = row_ids if isinstance(row_ids, (list, tuple)) and \
                isinstance(key, (list, tuple)) else [row_ids] * len(keys)
            for k, o, r in zip(keys, outs, rids):
                ids = sp._index_tensor(r, "cpu")
                shape = _first_target(o).shape
                _, rows, ids = self._rpc("row_sparse_pull", self._key(k),
                                         ids)
                rows, ids = _tensor(rows), _tensor(ids)
                if telemetry.is_enabled():
                    telemetry.count("kvstore.pull_bytes",
                                    telemetry.nbytes_of(rows) +
                                    telemetry.nbytes_of(ids))
                write_rows(o, ids, rows, shape)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    # -- optimizer wiring ----------------------------------------------------
    def set_optimizer(self, optimizer):
        """Ship the optimizer to the server (``update_on_kvstore``; the
        reference pickles it to its servers the same way).  The server
        keeps a copy: ``Trainer.step`` refreshes its lr, rescale_grad and
        wd through ``set_optimizer_hparams``."""
        self.wait_all()
        self._rpc("set_optimizer", pickle.dumps(optimizer))
        self.updates_on_server = True

    def set_optimizer_hparams(self, lr=None, rescale_grad=None, wd=None):
        """Refresh the server's optimizer hyperparameters in place (its
        momentum and Adam state stay)."""
        self.wait_all()
        self._rpc("set_hparams", lr, rescale_grad, wd)

    def set_updater(self, updater):
        raise MXNetError(
            "dist_async runs the updater server-side; use set_optimizer "
            "(reference kvstore_dist.h has the same restriction)")

    def set_gradient_compression(self, compression_params):
        from . import gradient_compression as gc

        self._compression = gc.create(compression_params)
        self._residuals = {}

    # -- state / lifecycle ---------------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise MXNetError("dist_async keeps optimizer state server-side; "
                         "checkpoint from the server process")

    def load_optimizer_states(self, fname):
        raise MXNetError("dist_async keeps optimizer state server-side")

    def close(self):
        if getattr(self, "_closed", False):
            return
        self._closed = True
        if self._sender.is_alive():
            self.wait_all()
        self._queue.put((None, None))
        if self._sock is not None:
            try:
                with self._sock_lock:
                    self._chan.send(("bye",))
                self._sock.close()
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

