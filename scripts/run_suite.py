#!/usr/bin/env python
"""One-command full test suite with the known-good chunked procedure.

The full 40-file suite in one pytest invocation has hung on this box even
with a clean compile cache (workers asleep in futex, frozen CPU time —
CLAUDE.md), while the same files split into sequential chunks pass reliably.
This runner encodes that procedure so the next round (and the driver) can
invoke the suite blindly:

    python scripts/run_suite.py            # 4 sequential chunks
    python scripts/run_suite.py --chunks 5 --clean-cache

Each chunk runs as its own pytest process (inheriting pyproject's
``-n 4 --dist loadfile`` xdist settings) under a hard timeout; a chunk that
times out is killed BY ITS PROCESS GROUP (never by pattern) and retried
once with a fresh compile cache — the observed hang modes are compile-cache
corruption and the full-suite futex stall, both of which a clean retry
clears. Exit code 0 iff every chunk passed.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    REPO, ".jax_cache"
)
CHUNK_TIMEOUT = 2400  # seconds; the heaviest chunk (realistic-density e2e)


def clean_cache():
    shutil.rmtree(CACHE, ignore_errors=True)


# line-anchored markers of an xdist worker dying or the interpreter
# aborting (the cache-deserializer SEGFAULT kills a worker, not the master,
# so the master exits 1 like a plain failure). Deliberately SPECIFIC: a
# genuine test failure whose assertion message merely contains "crashed"
# must NOT trigger the ~30-min clean-cache recompile retry (advisor r3).
CRASH_RE = re.compile(
    r"^\[gw\d+\] node down"            # xdist: worker lost
    r"|^INTERNALERROR>"                # pytest internal crash report
    r"|replacing crashed worker"       # xdist restart notice
    r"|worker ['\"]?gw\d+['\"]? crashed"
    r"|^Fatal Python error:"           # faulthandler on SIGSEGV/SIGABRT
    r"|^Segmentation fault",
)


def run_chunk(files: list[str], timeout: int) -> tuple[bool, str]:
    """Run one pytest chunk in its own process group.

    Output is teed live (the chunks run for minutes; a silent pipe looks
    like a hang). Returns (ok, why); ``why`` starts with "crash"/"timeout"
    for the recoverable modes that warrant a clean-compile-cache retry
    (CLAUDE.md: cache corruption presents as a SEGFAULT in the jax cache
    deserializer — a signal exit or a crashed xdist worker — not only as
    a hang).
    """
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", *files],
        cwd=REPO,
        start_new_session=True,   # own PGID: we only ever kill exactly it
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        errors="replace",
    )
    crashed = []

    def tee():
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            if not crashed and CRASH_RE.search(line):
                crashed.append(line.rstrip())

    reader = threading.Thread(target=tee, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout)
        reader.join(timeout=30)
        if rc == 0:
            return True, "exit 0"
        if rc < 0:
            return False, f"crash (signal {-rc})"
        if crashed:
            return False, f"crash (worker died, exit {rc}: {crashed[0][:80]})"
        return False, f"exit {rc}"
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        reader.join(timeout=30)
        return False, "timeout (killed process group)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--clean-cache", action="store_true")
    ap.add_argument("--timeout", type=int, default=CHUNK_TIMEOUT)
    args = ap.parse_args()

    if args.clean_cache:
        clean_cache()

    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))
    if not files:
        print("no test files found", file=sys.stderr)
        return 2
    n = args.chunks
    # distribute by weight (known-heavy KITTI-density e2e files first, snake
    # order) so no chunk stacks several multi-minute files
    HEAVY = {
        "test_realistic_proxy.py": 10,
        "test_iris_realistic.py": 10,
        "test_grsd_realistic.py": 8,      # 4 full-density descriptors (~100 s)
        "test_run_multi_tcp.py": 8,       # 2-process 60-frame CLI e2e (~110 s)
        "test_solver_scale.py": 5,
        "test_kitti_format.py": 4,        # mini-dataset write + CLI e2e (~55 s)
        "test_pipeline.py": 4,
        "test_mesh_drain.py": 3,
        "test_descriptor_families.py": 3,
    }
    files.sort(key=lambda f: -HEAVY.get(os.path.basename(f), 1))
    chunks = [[] for _ in range(n)]
    for k, f in enumerate(files):
        lane = k % (2 * n)
        chunks[lane if lane < n else 2 * n - 1 - lane].append(f)

    t_start = time.time()
    failures = []
    for ci, chunk in enumerate(chunks):
        names = [os.path.basename(f) for f in chunk]
        print(f"[suite] chunk {ci + 1}/{n}: {len(chunk)} files "
              f"({', '.join(names[:4])}{', ...' if len(names) > 4 else ''})",
              flush=True)
        t0 = time.time()
        ok, why = run_chunk(chunk, args.timeout)
        if not ok and (why.startswith("timeout") or why.startswith("crash")):
            # HANGS and CRASHES get the clean-cache retry (the observed
            # recoverable modes are cache-corruption SEGFAULTs — a signal
            # exit or a dead xdist worker — and the futex stall); a plain
            # test failure is a genuine failure — re-running with a cold
            # cache would just burn ~30 min of recompiles to fail again
            print(f"[suite] chunk {ci + 1} FAILED ({why}); retrying once "
                  f"with a clean compile cache", flush=True)
            clean_cache()
            ok, why = run_chunk(chunk, args.timeout)
        status = "ok" if ok else f"FAILED ({why})"
        print(f"[suite] chunk {ci + 1}: {status} in {time.time() - t0:.0f}s",
              flush=True)
        if not ok:
            failures.append((ci + 1, why))

    dt = time.time() - t_start
    if failures:
        print(f"[suite] FAILED chunks: {failures} ({dt:.0f}s total)")
        return 1
    print(f"[suite] all {n} chunks green in {dt:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
