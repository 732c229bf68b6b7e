"""Start the ranks of a distributed job: on this machine, or one ssh a
rank.

Counterpart of ``tools/launch.py`` (reference: the dmlc tracker's local
and ssh modes).  Every rank runs the same command with the env contract
``parallel.initialize`` reads:

    python -m mxnet_tpu_torch.launch -n 4 python train.py --lr 0.1

sets ``MXT_COORDINATOR`` (``--coordinator``, default
``127.0.0.1:<a free port>``, ``free_port``), ``MXT_NUM_PROCESSES=4``,
``MXT_PROCESS_ID=0..3``, ``MXT_INIT_TIMEOUT`` (the group's collective
timeout) and ``MXT_PS_SECRET``, one secret a job (the launcher's own
``MXT_PS_SECRET``, or a fresh random one) that the ``dist_async``
parameter server signs its frames with.  A script then calls
``mx.parallel.initialize()`` (NCCL, one card a rank) or
``mx.parallel.initialize(ctx=mx.cpu())`` (gloo on the host).

``--launcher local`` (the default) forks the ranks here and babysits
them (``launch_local``), each rank in a session of its own: when a rank
fails (a non-zero exit) or the wall-clock ``--timeout`` passes (124),
the others are stopped (SIGTERM, then SIGKILL to each rank's process
group after a grace period), so a rank stuck in a collective, or a
child it started, never outlives its job.  Then the whole group is
relaunched, up to ``--max-restarts`` times after a crash and
``--max-preemptions`` times after a graceful drain (a rank's exit 75,
``PREEMPTED_EXIT_CODE``: it wrote its drain checkpoint, so preemptions
do not burn the crash budget); the ranks resume from their latest
checkpoint (``checkpoint.resume``).  Relaunches back off exponentially
with jitter (``--backoff-base``, ``--backoff-cap``), and each relaunched
rank sees why in ``MXT_RESTART_REASON`` (``crash`` or ``preempted``), with
``MXT_RESTART_CRASHES``, ``MXT_RESTART_PREEMPTIONS`` and
``MXT_LAUNCH_ATTEMPT``.  SIGTERM on the launcher is passed on to every
rank as a drain, and the launcher then exits with the group's status,
relaunching nothing.

``--launcher ssh`` runs one ssh a rank, round robin over ``-H/--hostfile``
(``launch_ssh``), with the env contract exported on the remote shell;
the job's secret goes over ssh's stdin (``read -r MXT_PS_SECRET``), never
into argv.  ``MXT_SSH`` swaps the transport (a stub, a pod exec).
``--dry-run`` prints one command a rank instead, the secret referenced as
``${MXT_PS_SECRET:?...}`` for the runner to export on each host.

``run`` is one such attempt without relaunching (the multi-rank tests
start their ranks with it).
"""
from __future__ import annotations

import argparse
import os
import random
import secrets
import shlex
import signal
import socket
import subprocess
import sys
import time

__all__ = ["run", "launch_local", "launch_ssh", "ssh_commands", "main",
           "free_port", "PREEMPTED_EXIT_CODE", "install_drain_forwarder"]

#: a graceful preemption drain's exit status (``gluon.trainer``'s,
#: repeated here so the launcher imports no torch)
PREEMPTED_EXIT_CODE = 75


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


def _rank_env(base, n, r, coordinator, group_timeout, extra=None):
    e = dict(os.environ if base is None else base)
    e.update(MXT_COORDINATOR=coordinator, MXT_NUM_PROCESSES=str(n),
             MXT_PROCESS_ID=str(r), MXT_INIT_TIMEOUT=str(group_timeout))
    e.update(extra or {})
    return e


def _stop(procs, grace):
    """SIGTERM the live ranks, then, after ``grace`` seconds, SIGKILL
    every rank's process group (a rank blocked in a collective may never
    run its handler, and a rank's own children go with it)."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except OSError:
            pass  # the group is gone
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _group(n, cmd, coordinator, timeout, group_timeout, grace, env=None,
           extra=None, stdout=None, stderr=None, cwd=None, drain=False):
    """One attempt: start ranks 0..n-1 of ``cmd``, each in a session of
    its own, and wait for them.  At the first non-zero exit, or when
    ``timeout`` seconds have passed, the rest are stopped (``_stop``).
    Returns (the exit codes, one a rank; the group's status: the first
    failure's code, 124 after the timeout, else 0).  ``drain``: SIGTERM
    on the launcher reaches these ranks (``install_drain_forwarder``)."""
    procs, files = [], []
    try:
        for r in range(n):
            out = err = None
            if stdout is not None:
                out = open(stdout.format(rank=r), "wb")
                files.append(out)
            if stderr is not None:
                err = open(stderr.format(rank=r), "wb")
                files.append(err)
            procs.append(subprocess.Popen(
                cmd, env=_rank_env(env, n, r, coordinator, group_timeout,
                                   extra),
                stdout=out, stderr=err, cwd=cwd, start_new_session=True))
        if drain:
            _Drain.procs = procs
            if _Drain.requested:
                _forward_drain()  # the SIGTERM came during the spawn
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            status = next((c for c in codes if c not in (None, 0)), None)
            if status is None and None not in codes:
                status = 0
            if status is None and time.monotonic() > deadline:
                status = 124
            if status is not None:
                break
            time.sleep(0.05)
    finally:
        if drain:
            _Drain.procs = []
        _stop(procs, grace)
        for f in files:
            f.close()
    return [p.returncode for p in procs], status


def run(n, cmd, timeout=600.0, group_timeout=None, env=None, stdout=None,
        stderr=None, cwd=None, grace=10.0):
    """Run ``cmd`` (an argv list) as ranks 0..n-1 of one group on this
    machine and wait for them (one attempt, no relaunch).  Returns the
    exit codes, one a rank (negative, the signal's number, for a rank
    stopped after a peer failed); a timeout also makes every code of a
    rank it stopped 124.

    ``group_timeout`` (seconds, default ``timeout``) becomes
    ``MXT_INIT_TIMEOUT``; ``stdout``/``stderr`` are a file path pattern
    with ``{rank}`` or None (inherit); ``grace``: the seconds a stopped
    rank has between SIGTERM and SIGKILL."""
    codes, status = _group(n, cmd, f"127.0.0.1:{free_port()}", timeout,
                           group_timeout or timeout, grace, env=env,
                           stdout=stdout, stderr=stderr, cwd=cwd)
    if status == 124:
        codes = [124 if c is None or c < 0 else c for c in codes]
    return codes


# -- relaunch on failure -------------------------------------------------------

class _Drain:
    """What the SIGTERM forwarder sees: the live group, and whether the
    launcher itself was told to drain."""

    requested = False
    procs = []


def _forward_drain(_signum=None, _frame=None):
    _Drain.requested = True
    for p in list(_Drain.procs):
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass


def install_drain_forwarder():
    """SIGTERM on the launcher → SIGTERM to every rank (a graceful
    drain); ``launch_local`` then returns the group's status and
    relaunches nothing."""
    signal.signal(signal.SIGTERM, _forward_drain)


def _backoff_delay(restart_idx, base, cap, rand=random.random):
    """Exponential backoff with jitter: restart ``i`` waits
    uniform(0.5, 1.0) × min(cap, base·2^i) seconds, so relaunches of many
    preempted jobs do not arrive in step (and the old group's port leaves
    TIME_WAIT)."""
    if base <= 0:
        return 0.0
    return min(cap, base * (2 ** restart_idx)) * (0.5 + rand() / 2)


def launch_local(n, cmd, coordinator=None, timeout=3600.0,
                 group_timeout=None, max_restarts=0, max_preemptions=64,
                 backoff_base=1.0, backoff_cap=30.0, grace=10.0, env=None,
                 stats=None):
    """Fork ``n`` local ranks of ``cmd`` and babysit them, relaunching the
    whole group after a failure within the budgets (module docstring).
    Returns the exit status: 0, or the failing group's.  ``grace``: the
    seconds a stopped rank has between SIGTERM and SIGKILL; ``stats`` (a
    dict) receives the restart counts by reason."""
    secret = os.environ.get("MXT_PS_SECRET") or secrets.token_hex(16)
    restarts = {"crash": 0, "preempted": 0}
    if stats is not None:
        stats["restarts"] = restarts
    reason = None
    while True:
        coord = coordinator or f"127.0.0.1:{free_port()}"
        extra = {"MXT_PS_SECRET": secret,
                 "MXT_LAUNCH_ATTEMPT": str(sum(restarts.values())),
                 "MXT_RESTART_CRASHES": str(restarts["crash"]),
                 "MXT_RESTART_PREEMPTIONS": str(restarts["preempted"])}
        if reason is not None:
            extra["MXT_RESTART_REASON"] = reason
        _, rc = _group(n, cmd, coord, timeout, group_timeout or timeout,
                       grace, env=env, extra=extra, drain=True)
        if rc == 0:
            return 0
        if _Drain.requested:
            return rc  # the launcher itself drains: no relaunch
        reason = "preempted" if rc == PREEMPTED_EXIT_CODE else "crash"
        budget = max_preemptions if reason == "preempted" else max_restarts
        if restarts[reason] >= budget:
            print(f"launch: group failed (rc={rc}, {reason}); {reason} "
                  f"budget exhausted ({restarts[reason]}/{budget})",
                  file=sys.stderr)
            return rc
        restarts[reason] += 1
        delay = _backoff_delay(restarts[reason] - 1, backoff_base,
                               backoff_cap)
        print(f"launch: group failed (rc={rc}, {reason}); restart "
              f"{restarts[reason]}/{budget} after {delay:.2f}s backoff",
              file=sys.stderr)
        time.sleep(delay)


# -- ssh ------------------------------------------------------------------------

def _exports(n, rank, coordinator, group_timeout):
    return (f"export MXT_COORDINATOR={shlex.quote(coordinator)}; "
            f"export MXT_NUM_PROCESSES={n}; export MXT_PROCESS_ID={rank}; "
            f"export MXT_INIT_TIMEOUT={shlex.quote(str(group_timeout))}; ")


def ssh_commands(hosts, n, cmd, coordinator, group_timeout=3600.0):
    """One shell line a rank (``--dry-run``).  The secret is not in
    them (lines land in logs and shell histories): each references
    ``${MXT_PS_SECRET:?...}``, which the remote shell expands, so the
    runner exports it on each host and a host without it fails loudly."""
    lines = []
    for rank in range(n):
        host = hosts[rank % len(hosts)]
        remote = (_exports(n, rank, coordinator, group_timeout) +
                  'export MXT_PS_SECRET="${MXT_PS_SECRET:?export a shared '
                  'MXT_PS_SECRET on each host}"; exec ' +
                  " ".join(shlex.quote(c) for c in cmd))
        lines.append(f"ssh {shlex.quote(host)} {shlex.quote(remote)}")
    return lines


def launch_ssh(hosts, n, cmd, coordinator, group_timeout=3600.0):
    """One ssh a rank (``MXT_SSH`` names the transport, default
    ``ssh``), each remote shell reading the job's secret from stdin
    before it exports the env contract and runs ``cmd``; waits for every
    rank and returns 0 or the first failing rank's status."""
    ssh = shlex.split(os.environ.get("MXT_SSH", "ssh"))
    secret = os.environ.get("MXT_PS_SECRET") or secrets.token_hex(16)
    procs = []
    for rank in range(n):
        host = hosts[rank % len(hosts)]
        remote = ("read -r MXT_PS_SECRET; export MXT_PS_SECRET; " +
                  _exports(n, rank, coordinator, group_timeout) + "exec " +
                  " ".join(shlex.quote(c) for c in cmd))
        p = subprocess.Popen(ssh + [host, remote], stdin=subprocess.PIPE)
        try:
            p.stdin.write((secret + "\n").encode())
            p.stdin.flush()
            p.stdin.close()
        except OSError:
            pass  # an ssh that failed at once: its status says so
        procs.append(p)
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Start the ranks of one distributed job.")
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--launcher", default="local", choices=["local", "ssh"])
    p.add_argument("-H", "--hostfile", default=None,
                   help="ssh: one host a line (default localhost)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the rendezvous (default 127.0.0.1 "
                        "and a free port)")
    p.add_argument("--dry-run", action="store_true",
                   help="ssh: print the commands instead of running them")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="local: wall-clock seconds an attempt may take "
                        "before every rank is stopped")
    p.add_argument("--group-timeout", type=float, default=None,
                   help="seconds a collective may wait (MXT_INIT_TIMEOUT)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="local: relaunches after a rank crashes")
    p.add_argument("--max-preemptions", type=int, default=64,
                   help="local: relaunches after a graceful drain (a "
                        f"rank's exit {PREEMPTED_EXIT_CODE})")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="local: seconds before the first relaunch "
                        "(doubling, jittered; 0 for none)")
    p.add_argument("--backoff-cap", type=float, default=30.0,
                   help="local: the longest backoff in seconds")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command to run")
    group_timeout = args.group_timeout or args.timeout
    if args.launcher == "local":
        if args.dry_run:
            p.error("--dry-run only applies to --launcher ssh")
        install_drain_forwarder()
        return launch_local(args.num_workers, args.command,
                            coordinator=args.coordinator,
                            timeout=args.timeout,
                            group_timeout=args.group_timeout,
                            max_restarts=args.max_restarts,
                            max_preemptions=args.max_preemptions,
                            backoff_base=args.backoff_base,
                            backoff_cap=args.backoff_cap)
    if args.max_restarts:
        p.error("--max-restarts only applies to --launcher local")
    hosts = ["localhost"]
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = [ln.strip() for ln in f if ln.strip()]
    coordinator = args.coordinator or f"127.0.0.1:{free_port()}"
    if args.dry_run:
        for line in ssh_commands(hosts, args.num_workers, args.command,
                                 coordinator, group_timeout):
            print(line)
        return 0
    return launch_ssh(hosts, args.num_workers, args.command, coordinator,
                      group_timeout)


if __name__ == "__main__":
    sys.exit(main())
