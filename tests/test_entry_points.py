"""Entry points on a machine without a GPU: they refuse instead of falling
back to the CPU, and the compile cache goes where it is told."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "JAX_COMPILATION_CACHE_DIR")}
    e.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=e, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], cwd=tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_bench_fails_without_gpu():
    p = _run(["bench.py"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs a GPU" in p.stderr


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {"PYTHONPATH": REPO}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    p = _run(
        ["-c", "import scl_slam, jax; "
               "print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, **env,
    )
    assert p.returncode == 0, p.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert p.stdout.strip() == want


class TestPlatformGpuRefuses:
    """``--platform gpu`` (the default) exits with an error on a machine
    whose JAX backend is not a GPU."""

    def test_run(self):
        from scl_slam import run

        with pytest.raises(SystemExit) as e:
            run.main(["--platform", "gpu", "--frames", "2"])
        assert "no GPU" in str(e.value.code)

    def test_run_multi(self):
        from scl_slam import run_multi

        with pytest.raises(SystemExit) as e:
            run_multi.main(["--robots", "2", "--frames", "4"])
        assert "no GPU" in str(e.value.code)

    def test_serve(self):
        from scl_slam.serve import SlamServer

        with pytest.raises(SystemExit) as e:
            SlamServer(platform="gpu")
        assert "no GPU" in str(e.value.code)

    def test_bench_quality(self, monkeypatch):
        monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
        import bench_quality

        monkeypatch.setattr(sys, "argv", ["bench_quality.py", "--quick"])
        with pytest.raises(SystemExit) as e:
            bench_quality.main()
        assert "no GPU" in str(e.value.code)

    def test_tcp_needs_a_gpu_per_robot(self, monkeypatch, capsys):
        from scl_slam import run_multi

        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
        rc = run_multi.main(
            ["--robots", "2", "--transport", "tcp", "--platform", "gpu"]
        )
        assert rc == 2
        assert "1 GPU(s) visible for 2 robots" in capsys.readouterr().err
