"""Elastic recovery: supervise a training process and relaunch it when it
dies (counterpart of pg_asr_tpu/utils/elastic.py).

A graceful stop (SIGTERM) already saves model_last mid-epoch and a rerun
resumes bit for bit (utils/preempt.py, train.py). This module adds the
other half: detecting an ungraceful death (a segfault, an OOM kill, an
injected fault) and relaunching the same command, which picks the run up
from model_last.

Two ways in:
  * the CLI: ``--mode train --max_restarts 3 ...``: cli.main re-runs itself
    as the supervised child (``-m pg_asr_tpu_torch.cli``; the environment
    variable CHILD_ENV marks the child so that it does not recurse). Under
    ``--mesh data=N`` the CLI's launcher supervises its N rank processes
    as one group (``supervise``): when one dies, the others are stopped
    and all N are relaunched together;
  * a library call: ``run_elastic([sys.executable, script, ...],
    max_restarts=3)``.

Fault injection for testing the path end to end: ``--fault_step N``
(``train.train(fault_step=)``) ends the process with
``os._exit(FAULT_EXIT)`` at global step N, with no handler and no flush, as
an OOM kill would. It fires once per model directory (the
``.fault_injected`` marker): the last checkpoint before the crash sits at
or before step N, so the relaunch replays step N, and a bare step check
would crash forever.

Scope: one host. Rank processes started by the user (``PGASR_DISTRIBUTED=1``,
several hosts) each supervise their own child, as the JAX package's hosts
do: a relaunched rank rejoins the process group with the same rank, which
needs its peers to have failed too (at once with gloo; with NCCL only at
the process group's timeout, a path not yet run on more than one card).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

# marks the supervised child, so that cli.main does not supervise again
CHILD_ENV = "PGASR_ELASTIC_CHILD"
# the exit code of an injected fault: not Python's 1 nor a shell's 126+
FAULT_EXIT = 17
# after one process of a group fails, how long the others have to end
GROUP_GRACE_S = 30.0


def package_env(env: dict | None = None) -> dict:
    """A copy of `env` (default os.environ) whose PYTHONPATH holds this
    package's parent directory: a child that runs ``-m
    pg_asr_tpu_torch.cli`` needs the package on its path, and a parent
    started as a script from outside the repository had it only in its own
    sys.path."""
    env = dict(env if env is not None else os.environ)
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    pp = env.get("PYTHONPATH", "")
    if pkg_parent not in pp.split(os.pathsep):
        env["PYTHONPATH"] = pkg_parent + (os.pathsep + pp if pp else "")
    return env


def run_elastic(cmd: list[str], max_restarts: int = 3,
                backoff_s: float = 1.0, env: dict | None = None,
                on_restart=None) -> int:
    """Run `cmd` under crash supervision (``supervise``, a group of one
    process); returns the final exit code.

    on_restart(attempt, rc) is called before each relaunch (tests count the
    restarts with it).
    """
    env = package_env(env)
    env[CHILD_ENV] = "1"
    return supervise(lambda: [subprocess.Popen(cmd, env=env)],
                     max_restarts=max_restarts, backoff_s=backoff_s,
                     on_restart=on_restart)


def supervise(spawn, max_restarts: int = 0, backoff_s: float = 1.0,
              on_restart=None, grace_s: float = GROUP_GRACE_S) -> int:
    """Run the processes that ``spawn()`` starts (a list of Popen: one
    child, or the N ranks of a data axis) as one group under crash
    supervision; returns the final exit code, the first failing process's
    or 0.

    * every process exits 0: done, return.
    * SIGTERM or SIGINT to the supervisor: forwarded to every process,
      whose preemption handlers save model_last; the group's exit then
      ends the supervision without a restart (the platform asked for a
      stop).
    * a process exits other than 0: the others get `grace_s` to end on
      their own (a rank's peers fail at their next collective with gloo;
      with NCCL they may wait for the process group's timeout), then are
      killed; the whole group is then relaunched (the trainers resume
      from model_last; ``spawn`` gives the ranks a new rendezvous) up to
      `max_restarts` times, waiting backoff_s x the restart's number
      before each. Nothing depends on a peer seeing the failure.

    on_restart(attempt, rc) is called before each relaunch.
    """
    restarts = 0
    state = {"stopping": False, "children": []}

    def forward(signum, frame):
        state["stopping"] = True
        for child in state["children"]:
            if child.poll() is None:
                child.send_signal(signum)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread: supervise without it
            pass

    try:
        while True:
            state["children"] = spawn()
            rc = _wait_group(state["children"], grace_s)
            if rc == 0 or state["stopping"]:
                return rc
            if restarts >= max_restarts:
                if max_restarts:
                    print(f"[elastic] child exited rc={rc}; restart budget "
                          f"({max_restarts}) exhausted", file=sys.stderr)
                return rc
            restarts += 1
            if on_restart is not None:
                on_restart(restarts, rc)
            print(f"[elastic] child exited rc={rc}; restart "
                  f"{restarts}/{max_restarts} in {backoff_s * restarts:.1f}s"
                  " (the relaunch resumes from model_last)",
                  file=sys.stderr)
            time.sleep(backoff_s * restarts)
    finally:
        for child in state["children"]:
            if child.poll() is None:
                child.kill()
            child.wait()
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass


def _wait_group(procs: list[subprocess.Popen], grace_s: float) -> int:
    """Wait for every process of a group; once one has failed, kill those
    still running after `grace_s`. Returns the first failing process's
    exit code, or 0."""
    failed, deadline = 0, None
    while any(p.poll() is None for p in procs):  # polls every process
        if not failed:
            failed = next((p.returncode for p in procs
                           if p.returncode not in (None, 0)), 0)
            if failed:
                deadline = time.monotonic() + grace_s
        elif time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.05)
    return failed or next((p.returncode for p in procs if p.returncode), 0)
