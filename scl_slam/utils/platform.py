"""Backend selection shared by the command-line entry points."""
from __future__ import annotations

PLATFORMS = ("gpu", "cpu")


def select(platform: str) -> None:
    """``cpu`` forces JAX onto the CPU; ``gpu`` requires that JAX's default
    backend is a GPU and exits with an error otherwise (there is no silent
    CPU fallback). Call before the first computation."""
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"--platform gpu: JAX found no GPU (backend {backend!r}); "
            "pass --platform cpu to run on the CPU"
        )
