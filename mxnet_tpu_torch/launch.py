"""Start N local ranks of a distributed job.

Counterpart of the ``--launcher local`` part of ``tools/launch.py``
(reference: the dmlc tracker's local mode).  Every rank runs the same
command with the env contract ``parallel.initialize`` reads:

    python -m mxnet_tpu_torch.launch -n 4 python train.py --lr 0.1

sets ``MXT_COORDINATOR=127.0.0.1:<port>`` (a free port, ``free_port``),
``MXT_NUM_PROCESSES=4``, ``MXT_PROCESS_ID=0..3`` and
``MXT_INIT_TIMEOUT`` (the group's collective timeout) for each rank.  A
script then calls ``mx.parallel.initialize()`` (NCCL, one card a rank)
or ``mx.parallel.initialize(ctx=mx.cpu())`` (gloo on the host).

The launcher waits for the ranks under a wall-clock ``--timeout``; when
one rank fails (a non-zero exit) or the time is up, it kills the others,
so a rank stuck in a collective never outlives its job.  The exit
status is the first failing rank's (124 on a timeout).  ``run`` is the
same as a function (the multi-rank tests start their ranks with it).

Left out of slice 12 (ROADMAP.md): the ``ssh`` launcher and its per-job
secret, and relaunch on failure (elastic re-formation).
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import time

__all__ = ["run", "main", "free_port"]


def free_port():
    """A TCP port on 127.0.0.1 that was free just now, drawn below the
    kernel's ephemeral range: the rendezvous binds it seconds later, and
    a port from that range could meanwhile go to another process's
    outgoing connection (a gloo group's, say)."""
    rng = random.SystemRandom()
    for _ in range(100):
        port = rng.randrange(20000, 32768)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def run(n, cmd, timeout=600.0, group_timeout=None, env=None, stdout=None,
        stderr=None, cwd=None):
    """Run ``cmd`` (an argv list) as ranks 0..n-1 of one group on this
    machine and wait for them.  Returns the exit codes, one a rank
    (-9 for a rank killed after a peer failed or the time ran out); a
    timeout also makes every code that was still running 124.

    ``group_timeout`` (seconds, default ``timeout``) becomes
    ``MXT_INIT_TIMEOUT``; ``stdout``/``stderr`` are a file path pattern
    with ``{rank}`` or None (inherit)."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(n):
            e = dict(os.environ if env is None else env)
            e.update(MXT_COORDINATOR=f"127.0.0.1:{port}",
                     MXT_NUM_PROCESSES=str(n), MXT_PROCESS_ID=str(r),
                     MXT_INIT_TIMEOUT=str(group_timeout or timeout))
            out = err = None
            if stdout is not None:
                out = open(stdout.format(rank=r), "wb")
                files.append(out)
            if stderr is not None:
                err = open(stderr.format(rank=r), "wb")
                files.append(err)
            procs.append(subprocess.Popen(cmd, env=e, stdout=out, stderr=err,
                                          cwd=cwd, start_new_session=True))
        deadline = time.monotonic() + timeout
        codes = [None] * n
        timed_out = False
        while any(c is None for c in codes):
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
            if any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        _kill(procs)
        codes = [p.returncode if c is None else c
                 for c, p in zip(codes, procs)]
        if timed_out:
            codes = [124 if c is None or c < 0 else c for c in codes]
        return codes
    finally:
        _kill(procs)
        for f in files:
            f.close()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Start N local ranks of one distributed job.")
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--launcher", default="local")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="wall-clock seconds before every rank is killed")
    p.add_argument("--group-timeout", type=float, default=None,
                   help="seconds a collective may wait (MXT_INIT_TIMEOUT)")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.launcher != "local":
        print(f"launcher {args.launcher!r} is not ported yet (ROADMAP.md, "
              "\"Left out of slice 12\")", file=sys.stderr)
        return 2
    if not args.command:
        p.error("no command to run")
    codes = run(args.num_workers, args.command, timeout=args.timeout,
                group_timeout=args.group_timeout)
    bad = [c for c in codes if c != 0]
    return bad[0] if bad else 0


if __name__ == "__main__":
    sys.exit(main())
