"""chip_smoke.py's processes on the CPU: every process it starts goes through
start_process, reap_all ends them on every way out of main(), and
audit_processes, which only reads /proc, names what outlived its teardown.

Each case runs a script of its own that imports chip_smoke and starts, through
the helper, a `python -c` child that starts a grandchild in a new session and
sleeps: the audit names the grandchild (a descendant while its parent lives,
by its command line naming the run's directory once orphaned), the reaper
leaves no process of the script's behind, and a SIGTERM to the script ends
its children through the same teardown."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = ("import subprocess, sys, time; "
         "g = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)', sys.argv[1]], "
         "start_new_session=True); print(g.pid, flush=True); time.sleep(120)")

SCRIPT = r"""
import json, os, signal, subprocess, sys, time
import chip_smoke as cs

run_dir, mode, child_code = sys.argv[1], sys.argv[2], sys.argv[3]
cs.RUN_DIRS.append(run_dir)
signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
try:
    child = cs.start_process([sys.executable, "-c", child_code, run_dir], stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
    grandchild = int(child.stdout.readline())
    if mode == "orphan":  # the grandchild's parent ends: it is no descendant any more
        os.killpg(child.pid, signal.SIGKILL)
        child.wait()
    found = cs.audit_processes()
    print(json.dumps({"child": child.pid, "grandchild": grandchild, "found": [list(f) for f in found]}), flush=True)
    if mode == "fail":
        cs.audit_or_fail()
    if mode == "wait":
        time.sleep(120)  # the test's SIGTERM lands here
finally:
    cs.reap_all(grace=2.0)
    print(json.dumps({"left": [list(f) for f in cs.audit_processes()]}), flush=True)
"""


def _run(tmp_path, mode):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    run_dir = str(tmp_path / "chip-smoke-run")
    os.makedirs(run_dir)
    return subprocess.Popen([sys.executable, "-c", SCRIPT, run_dir, mode, CHILD], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), run_dir


def _live(pid):
    """Whether pid is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        return False


def _gone(*pids, timeout=10.0):
    deadline = time.monotonic() + timeout
    while any(_live(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not any(_live(p) for p in pids)


@pytest.mark.parametrize("mode", ["descendant", "orphan"])
def test_audit_names_the_grandchild_and_the_reaper_leaves_nothing(tmp_path, mode):
    """The audit names the grandchild that started a session of its own:
    as a descendant while its parent lives, by the run's directory on its
    command line once orphaned. reap_all then leaves no process of the
    script's alive."""
    proc, run_dir = _run(tmp_path, mode)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, out + err
    first, last = (json.loads(line) for line in out.splitlines()[-2:])
    found = {pid: (ppid, session, cmd) for pid, ppid, session, cmd in first["found"]}
    grandchild = first["grandchild"]
    assert grandchild in found, first
    assert found[grandchild][1] == grandchild  # it leads a session of its own, outside the child's
    assert run_dir in found[grandchild][2]
    if mode == "descendant":
        assert first["child"] in found and found[grandchild][0] == first["child"]
    else:
        assert first["child"] not in found and found[grandchild][0] != first["child"]
    assert last == {"left": []}
    assert _gone(first["child"], grandchild)


def test_audit_or_fail_names_each_process_and_fails(tmp_path):
    """A process left alive fails the run by name: one line each (pid,
    ppid, session, command line), then an AssertionError; the teardown
    still reaps them."""
    proc, run_dir = _run(tmp_path, "fail")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 1, out + err
    first = json.loads(out.splitlines()[0])
    assert f"audit: process {first['grandchild']} (ppid {first['child']}, session {first['grandchild']})" in out
    assert f"audit: process {first['child']} " in out
    assert "AssertionError: audit: 2 process(es) that the script started are still alive" in err
    assert json.loads(out.splitlines()[-1]) == {"left": []}
    assert _gone(first["child"], first["grandchild"])


def test_sigterm_to_the_script_ends_its_children(tmp_path):
    """A SIGTERM to a script that starts its processes through the helper
    unwinds through its finally: the child and the grandchild in a new
    session both end, and the script exits 143."""
    proc, _ = _run(tmp_path, "wait")
    first = json.loads(proc.stdout.readline())
    assert _live(first["child"]) and _live(first["grandchild"])
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 128 + signal.SIGTERM, out + err
    assert json.loads(out.splitlines()[-1]) == {"left": []}
    assert _gone(first["child"], first["grandchild"])


def test_run_process_checks_the_exit_code_and_the_time_limit():
    """One-shot commands go through the helper too: their output, a
    non-zero exit failing the named step, and a command past its time limit
    killed with its group."""
    import chip_smoke as cs

    n = len(cs.STARTED)
    assert cs.run_process([sys.executable, "-c", "print('hi')"], 30, "step").stdout == "hi\n"
    with pytest.raises(AssertionError, match="step: .* exited 3"):
        cs.run_process([sys.executable, "-c", "import sys; sys.exit(3)"], 30, "step")
    with pytest.raises(AssertionError, match="step: .* ran past 0.5 s"):
        cs.run_process([sys.executable, "-c", "import time; time.sleep(30)"], 0.5, "step")
    started = cs.STARTED[n:]
    assert len(started) == 3 and all(g == h.pid for h, g in started)
    assert all(h.poll() is not None for h, _ in started)
    del cs.STARTED[n:]


APP_SCRIPT = r"""
import json, os, sys
import chip_smoke as cs

run_dir, addr = sys.argv[1], sys.argv[2]
cs.RUN_DIRS.append(run_dir)
try:
    app, listening = cs.app_process(run_dir, "left-app", addr)
    print(json.dumps({"app": app.proc.pid, "addr": listening}), flush=True)
    cs.audit_or_fail()
finally:
    cs.reap_all(grace=2.0)
    print(json.dumps({"left": [list(f) for f in cs.audit_processes()]}), flush=True)
"""


@pytest.mark.parametrize("scheme", ["tcp", "grpc"])
def test_audit_names_a_left_over_app_process(tmp_path, scheme):
    """Phase 18's apps: the port's kvstore behind its socket or gRPC server in
    a process of its own (chip_smoke.app_process), left running, is named
    by the audit (its command line), fails the run, and the teardown reaps
    it."""
    if scheme == "grpc":
        pytest.importorskip("grpc")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    run_dir = str(tmp_path / "chip-smoke-run")
    os.makedirs(run_dir)
    proc = subprocess.Popen([sys.executable, "-c", APP_SCRIPT, run_dir, f"{scheme}://127.0.0.1:0"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 1, out + err
    first = json.loads(out.splitlines()[0])
    assert first["addr"].startswith(f"{scheme}://127.0.0.1:")
    line = next(x for x in out.splitlines() if x.startswith(f"audit: process {first['app']} "))
    assert "-m tendermint_tpu_torch.abci.socket --addr" in line
    assert "AssertionError: audit: 1 process(es) that the script started are still alive" in err
    assert json.loads(out.splitlines()[-1]) == {"left": []}
    assert _gone(first["app"])
