"""True multi-process distributed solve over jax.distributed + Gloo.

Spawns 2 python processes, each with 2 virtual CPU devices; the
factor-sharded GN solve runs over the 4-device global mesh. This is the
mechanical analog of an N-host pod (SURVEY §7.9) — same code path, Gloo
instead of NCCL.
"""
import os
import subprocess
import sys

import pytest


def test_two_process_sharded_solve():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    port = "47411"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "RESULT" in out
    # both processes must report the same optimum (replicated outputs)
    lines = [
        next(l for l in out.splitlines() if l.startswith("RESULT")) for out in outs
    ]
    vals = [l.split("chi_last=")[1].split()[0] for l in lines]
    assert vals[0] == vals[1], f"processes disagree: {lines}"
