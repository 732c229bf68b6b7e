"""The port's launcher (``python -m mxnet_tpu_torch.launch``): the ssh
mode through an ``MXT_SSH`` stub, its dry run, relaunch on failure with
its two budgets, the backoff's bounds (held to ``tools/launch.py``'s
``_backoff_delay``) and the SIGTERM drain.  The ranks are small Python
scripts that import nothing of either package."""
import importlib.util
import os
import signal
import subprocess
import sys
import time

import pytest

from mxnet_tpu_torch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
           os.environ.get("PYTHONPATH", ""))
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.launch"]


def _stub(tmp_path):
    """An ssh stand-in: logs its argv, then runs the remote command in a
    local shell (stdin passes through)."""
    stub = tmp_path / "fakessh"
    stub.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {tmp_path}/argv.log\n"
                    "host=\"$1\"; shift\n"
                    "exec sh -c \"$*\"\n")
    stub.chmod(0o755)
    return stub


def test_ssh_launcher_spawns_through_the_transport(tmp_path):
    """Each rank's env contract arrives exported on the "remote" shell,
    the job's secret over stdin: in the ranks' env, never in argv."""
    stub = _stub(tmp_path)
    hosts = tmp_path / "hosts"
    hosts.write_text("hostA\nhostB\n\n")
    script = tmp_path / "worker.py"
    script.write_text(
        "import os\n"
        "r = os.environ['MXT_PROCESS_ID']\n"
        f"open(r'{tmp_path}/out' + r, 'w').write(':'.join(os.environ[k] "
        "for k in ('MXT_NUM_PROCESSES', 'MXT_COORDINATOR', "
        "'MXT_PS_SECRET', 'MXT_INIT_TIMEOUT')))\n")
    env = dict(ENV, MXT_SSH=str(stub), MXT_PS_SECRET="sekrit-42")
    rc = subprocess.call(LAUNCH + [
        "-n", "3", "--launcher", "ssh", "-H", str(hosts), "--coordinator",
        "10.0.0.9:7777", "--group-timeout", "50", sys.executable,
        str(script)], env=env, cwd=ROOT, timeout=60)
    assert rc == 0
    for r in range(3):
        assert (tmp_path / f"out{r}").read_text() == \
            "3:10.0.0.9:7777:sekrit-42:50.0"
    argv = (tmp_path / "argv.log").read_text().splitlines()
    assert [a.split()[0] for a in argv] == ["hostA", "hostB", "hostA"]
    assert "sekrit-42" not in "".join(argv)


def test_ssh_launcher_returns_a_failing_rank_s_status(tmp_path):
    stub = _stub(tmp_path)
    env = dict(ENV, MXT_SSH=str(stub))
    rc = subprocess.call(LAUNCH + [
        "-n", "2", "--launcher", "ssh", sys.executable, "-c",
        "import os, sys; sys.exit(5 if os.environ['MXT_PROCESS_ID'] == '1'"
        " else 0)"], env=env, cwd=ROOT, timeout=60)
    assert rc == 5


def test_ssh_dry_run_prints_the_commands_without_the_secret():
    env = dict(ENV, MXT_PS_SECRET="must-not-leak")
    res = subprocess.run(LAUNCH + ["-n", "2", "--launcher", "ssh",
                                   "--dry-run", "python", "t.py"],
                         env=env, capture_output=True, text=True, cwd=ROOT,
                         timeout=60)
    assert res.returncode == 0
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 2 and all(ln.startswith("ssh localhost ")
                                   for ln in lines)
    assert "must-not-leak" not in res.stdout
    assert "MXT_PROCESS_ID=1" in lines[1]
    assert "${MXT_PS_SECRET:?" in lines[0]
    lines = launch.ssh_commands(["hostA", "hostB"], 4, ["python", "t.py"],
                                "10.0.0.1:1234")
    assert [ln.split()[1] for ln in lines] == ["hostA", "hostB"] * 2
    assert "MXT_PROCESS_ID=3" in lines[3]
    bad = subprocess.run(LAUNCH + ["-n", "2", "--dry-run", "python", "t"],
                         env=ENV, capture_output=True, text=True, cwd=ROOT,
                         timeout=60)
    assert bad.returncode == 2 and "only applies to --launcher ssh" in \
        bad.stderr


# rank 1 fails an attempt only after rank 0 has written its record: the
# launcher stops the peers of a failed rank at once
FLAKY = """
import os, sys, time
attempt = int(os.environ["MXT_LAUNCH_ATTEMPT"])
r = os.environ["MXT_PROCESS_ID"]
with open(sys.argv[1] + "/a%d.r%s.tmp" % (attempt, r), "w") as f:
    f.write(" ".join(os.environ.get(k, "-") for k in (
        "MXT_RESTART_REASON", "MXT_RESTART_CRASHES",
        "MXT_RESTART_PREEMPTIONS", "MXT_PS_SECRET")))
os.replace(sys.argv[1] + "/a%d.r%s.tmp" % (attempt, r),
           sys.argv[1] + "/a%d.r%s" % (attempt, r))
codes = [int(c) for c in sys.argv[2].split(",")]
if r == "1" and attempt < len(codes):
    peer = sys.argv[1] + "/a%d.r0" % attempt
    deadline = time.monotonic() + 60
    while not os.path.exists(peer) and time.monotonic() < deadline:
        time.sleep(0.01)
    sys.exit(codes[attempt])
"""


def _flaky(tmp_path, codes, **kw):
    script = tmp_path / "flaky.py"
    script.write_text(FLAKY)
    stats = {}
    rc = launch.launch_local(2, [sys.executable, str(script), str(tmp_path),
                                 codes], timeout=60, backoff_base=0,
                             grace=5, env=ENV, stats=stats, **kw)
    return rc, stats["restarts"]


@pytest.mark.parametrize("codes,kw,want_rc,want", [
    ("3", dict(max_restarts=1), 0, {"crash": 1, "preempted": 0}),
    ("3,3", dict(max_restarts=1), 3, {"crash": 1, "preempted": 0}),
    # preemptions (exit 75) take from their own budget, not the crash one
    ("75,75", dict(max_restarts=0, max_preemptions=2), 0,
     {"crash": 0, "preempted": 2}),
    ("75,75", dict(max_restarts=5, max_preemptions=1), 75,
     {"crash": 0, "preempted": 1}),
    ("75,3", dict(max_restarts=1, max_preemptions=1), 0,
     {"crash": 1, "preempted": 1}),
])
def test_relaunch_budgets(tmp_path, codes, kw, want_rc, want):
    rc, restarts = _flaky(tmp_path, codes, **kw)
    assert rc == want_rc and restarts == want
    seq = [int(c) for c in codes.split(",")]
    attempts = sum(want.values()) + 1
    secrets = set()
    for a in range(attempts):
        reason = "-" if a == 0 else \
            ("preempted" if seq[a - 1] == 75 else "crash")
        crashes = sum(c != 75 for c in seq[:a])
        for r in range(2):
            fields = (tmp_path / f"a{a}.r{r}").read_text().split()
            assert fields[:3] == [reason, str(crashes), str(a - crashes)]
            secrets.add(fields[3])
    assert not (tmp_path / f"a{attempts}.r0").exists()
    assert len(secrets) == 1 and len(secrets.pop()) >= 16  # one a job


def test_backoff_bounds_match_the_reference():
    spec = importlib.util.spec_from_file_location(
        "_ref_launch", os.path.join(ROOT, "tools", "launch.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for i in range(8):
        for u in (0.0, 0.3, 1.0):
            got = launch._backoff_delay(i, 1.0, 30.0, lambda: u)
            assert got == ref._backoff_delay(i, 1.0, 30.0, lambda: u)
            lo, hi = 0.5 * min(30.0, 2.0 ** i), min(30.0, 2.0 ** i)
            assert lo <= got <= hi
    assert launch._backoff_delay(3, 0.0, 30.0) == 0.0
    assert launch._backoff_delay(20, 1.0, 30.0) <= 30.0


DRAINER = """
import os, signal, sys, time
attempt = os.environ["MXT_LAUNCH_ATTEMPT"]
r = os.environ["MXT_PROCESS_ID"]
def drain(*_):
    open(sys.argv[1] + "/drained.a%s.r%s" % (attempt, r), "w").write("1")
    sys.exit(75)
signal.signal(signal.SIGTERM, drain)
open(sys.argv[1] + "/up.a%s.r%s" % (attempt, r), "w").write("1")
time.sleep(60)
"""


def test_sigterm_on_the_launcher_drains_every_rank(tmp_path):
    """SIGTERM on the launcher reaches every rank as a drain; the
    launcher exits with the group's status (75) and relaunches nothing,
    whatever its preemption budget."""
    script = tmp_path / "drainer.py"
    script.write_text(DRAINER)
    proc = subprocess.Popen(LAUNCH + ["-n", "2", "--max-preemptions", "5",
                                      "--backoff-base", "0",
                                      sys.executable, str(script),
                                      str(tmp_path)], env=ENV, cwd=ROOT)
    try:
        deadline = time.monotonic() + 60
        while not all((tmp_path / f"up.a0.r{r}").exists() for r in range(2)):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
    assert all((tmp_path / f"drained.a0.r{r}").exists() for r in range(2))
    assert not list(tmp_path.glob("up.a1.*"))


def test_a_hung_group_is_killed_at_the_timeout(tmp_path):
    """Ranks that ignore SIGTERM and hang are killed after the grace
    period once the attempt's wall clock runs out (124, a crash)."""
    script = tmp_path / "hang.py"
    script.write_text("import signal, time\n"
                      "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                      "time.sleep(120)\n")
    t = time.monotonic()
    stats = {}
    rc = launch.launch_local(2, [sys.executable, str(script)], timeout=2,
                             grace=1, backoff_base=0, env=ENV, stats=stats)
    assert rc == 124 and stats["restarts"] == {"crash": 0, "preempted": 0}
    assert time.monotonic() - t < 30


# rank 0 starts a child that would sleep on, then rank 1 fails
SPAWNER = """
import os, subprocess, sys, time
r = os.environ["MXT_PROCESS_ID"]
if r == "0":
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"])
    open(sys.argv[1] + "/child", "w").write(str(child.pid))
    time.sleep(120)
while not os.path.exists(sys.argv[1] + "/child"):
    time.sleep(0.01)
sys.exit(3)
"""


@pytest.mark.parametrize("entry", ["run", "launch_local"])
def test_a_failed_group_is_stopped_with_its_children(tmp_path, entry):
    """``run`` and ``launch_local`` stop a group the same way: at a rank's
    failure its peers get SIGTERM, and every rank's process group is
    killed, so a child a rank started does not outlive the job."""
    script = tmp_path / "spawner.py"
    script.write_text(SPAWNER)
    cmd = [sys.executable, str(script), str(tmp_path)]
    t = time.monotonic()
    if entry == "run":
        codes = launch.run(2, cmd, timeout=60, grace=5, env=ENV)
        assert codes == [-signal.SIGTERM, 3]
    else:
        assert launch.launch_local(2, cmd, timeout=60, backoff_base=0,
                                   grace=5, env=ENV) == 3
    assert time.monotonic() - t < 30
    pid = int((tmp_path / "child").read_text())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"rank 0's child {pid} outlived the group")
