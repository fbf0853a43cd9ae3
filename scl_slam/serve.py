"""Long-lived SLAM service — scans in over a socket, poses out.

The production-serving shape of the runtime (ROADMAP §4): one process owns a
:class:`Mapper` (and optionally the ICP odometry front end), accepts framed
requests over TCP, and answers with poses/trajectories. The wire protocol
reuses the length-prefixed pickle-free npz framing of
:mod:`.runtime.transport` (no code execution on deserialization).

Protocol (request, response) pairs:

- ``("frame", {"xyz": [N,3] f32, "pose": [4,4] | None, "stamp": float})`` ->
  ``{"keyframe": bool, "pose": [4,4], "loop": dict | None}``
  (pose=None requires the server to run its own odometry)
- ``("trajectory", {"robot": int | None})`` -> ``{"poses": [M,4,4], "stamps": [M]}``
- ``("save", {"directory": str})`` -> ``{"ok": True}``
- ``("stats", {})`` -> counters
- ``("shutdown", {})`` -> stops the server

Start:  python -m scl_slam.serve --port 7450 [--odometry icp] [--config cfg.yaml]
Client: :class:`SlamClient` below.
"""
from __future__ import annotations

import argparse
import socket
import threading

import numpy as np

from .runtime.transport import _recv_frame, _send_frame


class SlamServer:
    def __init__(self, cfg=None, odometry: str = "none", platform: str = "gpu"):
        from .utils import platform as _platform

        _platform.select(platform)
        from .config import SlamConfig
        from .runtime import Mapper

        self.cfg = cfg or SlamConfig()
        self.mapper = Mapper(self.cfg)
        self.odo = None
        if odometry == "icp":
            from .runtime.odometry import Odometry

            self.odo = Odometry()
        self._lock = threading.Lock()
        self._frames = 0
        self._loops = 0
        self._stop = threading.Event()

    def handle(self, kind: str, payload: dict):
        import jax.numpy as jnp

        from .geometry import se3

        if kind == "frame":
            xyz = np.asarray(payload["xyz"], np.float32)
            with self._lock:
                self._frames += 1
                if payload.get("pose") is not None:
                    T = np.asarray(payload["pose"], np.float32)
                    pose = se3.Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))
                elif self.odo is not None:
                    pose, _ = self.odo.step(xyz)
                else:
                    return {"error": "no pose given and odometry disabled"}
                wire = self.mapper.add_frame(
                    pose, xyz, stamp=float(payload.get("stamp", 0.0))
                )
                loop = None
                if wire is not None:
                    info = self.mapper.spin_once()
                    loop = info.get("loop")
                    if loop:
                        self._loops += 1
                K = self.cfg.keyframe.max_keyframes
                idx = int(self.mapper.state.counts[self.mapper.robot]) - 1
                slot = self.mapper.robot * K + max(idx, 0)
                T_out = np.eye(4)
                T_out[:3, :3] = np.asarray(self.mapper.state.opt_R[slot])
                T_out[:3, 3] = np.asarray(self.mapper.state.opt_t[slot])
                return {"keyframe": wire is not None, "pose": T_out, "loop": loop}
        if kind == "trajectory":
            with self._lock:
                robot = payload.get("robot")
                return {
                    "poses": self.mapper.trajectory(robot=robot),
                    "stamps": self.mapper.keyframe_stamps(robot=robot),
                }
        if kind == "save":
            with self._lock:
                self.mapper.save_trajectories(payload["directory"])
                self.mapper.export_artifacts(payload["directory"])
            return {"ok": True}
        if kind == "stats":
            with self._lock:
                return {
                    "frames": self._frames,
                    "keyframes": int(self.mapper.state.counts[self.mapper.robot]),
                    "loops": self._loops,
                }
        if kind == "shutdown":
            self._stop.set()
            return {"ok": True}
        return {"error": f"unknown request {kind!r}"}

    def serve(self, port: int, host: str = "0.0.0.0"):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()
        srv.close()

    def _client(self, conn: socket.socket):
        from .runtime.transport import _DECODE_ERRORS

        try:
            while not self._stop.is_set():
                kind, payload = _recv_frame(conn)
                _send_frame(conn, ("resp", self.handle(kind, payload)))
        except (ConnectionError, EOFError, OSError, *_DECODE_ERRORS):
            pass  # disconnect or malformed frame: drop the connection
        finally:
            conn.close()


class SlamClient:
    """Blocking client for :class:`SlamServer`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7450, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, kind: str, payload: dict):
        _send_frame(self.sock, (kind, payload))
        _, resp = _recv_frame(self.sock)
        return resp

    def frame(self, xyz: np.ndarray, pose: np.ndarray | None = None, stamp: float = 0.0):
        return self._call("frame", {"xyz": xyz, "pose": pose, "stamp": stamp})

    def trajectory(self, robot: int | None = None):
        return self._call("trajectory", {"robot": robot})

    def save(self, directory: str):
        return self._call("save", {"directory": directory})

    def stats(self):
        return self._call("stats", {})

    def shutdown(self):
        return self._call("shutdown", {})

    def close(self):
        self.sock.close()


def main(argv=None):
    p = argparse.ArgumentParser(description="scl_slam serving daemon")
    p.add_argument("--port", type=int, default=7450)
    p.add_argument("--config", help="YAML config path")
    p.add_argument("--odometry", choices=["none", "icp"], default="none")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    args = p.parse_args(argv)
    cfg = None
    if args.config:
        from .config import load_config

        cfg = load_config(args.config)
    server = SlamServer(cfg, odometry=args.odometry, platform=args.platform)
    print(f"scl_slam serving on :{args.port}", flush=True)
    server.serve(args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
