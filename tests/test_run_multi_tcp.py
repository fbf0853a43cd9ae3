"""run_multi --transport tcp: process-per-robot deployment from the CLI.

The reference's deployment shape is one ROS node per robot over TCPROS;
this drives the analog end-to-end: run_multi spawns one run_robot.py
process per robot, descriptors stream over persistent TcpBus sockets,
verification RPCs cross processes, and robot 0's worker produces the
joint report + figure. (Transport semantics themselves are covered by
tests/test_transport.py::TestTcpBusCrossProcess; this covers the CLI
orchestration layer.)
"""
import json
import os

import pytest


@pytest.mark.timeout(600)
def test_tcp_two_process_end_to_end(tmp_path, capsys):
    from scl_slam import run_multi

    out = str(tmp_path / "tcp_run")
    rc = run_multi.main([
        "--robots", "2", "--frames", "60", "--transport", "tcp",
        "--platform", "cpu", "--output", out,
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "decentralized-tcp"
    assert report["robots"] == 2
    # overlap split + robot 1 revisiting robot 0's segment must close at
    # least one inter-robot loop across the sockets (60 frames: the 40-
    # frame split spaces keyframes too far apart for the SC gate)
    assert report["inter_loops"] >= 1, report
    assert set(report["ate_rmse_m"]) == {"a", "b"}
    assert all(v < 1.0 for v in report["ate_rmse_m"].values()), report
    assert os.path.exists(os.path.join(out, "a_tum.txt"))
    if "figure" in report:
        assert os.path.exists(report["figure"])


@pytest.mark.timeout(600)
def test_tcp_permanent_failure_aborts_fast(tmp_path, capsys):
    """A worker that exhausts its respawn budget (here: zero) must fail
    the run IMMEDIATELY — the supervisor terminates the siblings instead
    of letting them burn the 900*R-second fed_<r> barrier timeout and
    their own respawn budgets (code-review r5)."""
    import time

    from scl_slam import run_multi

    out = str(tmp_path / "tcp_abort")
    t0 = time.monotonic()
    rc = run_multi.main([
        "--robots", "2", "--frames", "60", "--transport", "tcp",
        "--platform", "cpu", "--output", out,
        "--crash-robot", "0", "--crash-after", "5",
    ])
    wall = time.monotonic() - t0
    captured = capsys.readouterr()
    assert rc == 1, captured.err[-1000:]
    assert "exit codes" in captured.err
    # well under the 1800 s barrier timeout the old code waited out
    assert wall < 400, wall


@pytest.mark.timeout(600)
def test_tcp_respawn_resumes_crashed_worker(tmp_path, capsys):
    """Elastic restart (reference launch respawn="true",
    single_ugv.launch:4): robot 0 hard-crashes mid-feed (fault
    injection); the supervisor respawns it with --resume from its
    periodic checkpoint; the joint run still completes with a correct
    joint map (same assertions as the crash-free run)."""
    from scl_slam import run_multi

    out = str(tmp_path / "tcp_respawn")
    rc = run_multi.main([
        "--robots", "2", "--frames", "60", "--transport", "tcp",
        "--platform", "cpu", "--output", out,
        "--respawn", "2", "--checkpoint-every", "5",
        "--crash-robot", "0", "--crash-after", "12",
    ])
    captured = capsys.readouterr()
    assert "respawn 1/2" in captured.err, captured.err[-2000:]
    assert rc == 0, captured.err[-2000:]
    report = json.loads(captured.out.strip().splitlines()[-1])
    assert report["mode"] == "decentralized-tcp"
    # the resumed robot 0 must have its FULL segment (35 frames of 60
    # with the default 10-frame overlap => ~30+ raw frames; keyframe
    # count just needs to show both pre- and post-crash frames present)
    assert report["inter_loops"] >= 1, report
    assert set(report["ate_rmse_m"]) == {"a", "b"}
    assert all(v < 1.0 for v in report["ate_rmse_m"].values()), report
