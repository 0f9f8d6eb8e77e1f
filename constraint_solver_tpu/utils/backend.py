"""Backend set-up shared by the command-line entry points.

With no ``--platform`` JAX picks the device itself (the GPU when there is
one).  ``--platform cpu`` forces the host backend; ``--platform gpu`` fails
when JAX finds no GPU rather than running anywhere else.
"""

from __future__ import annotations

PLATFORMS = ("cpu", "gpu")


def add_platform_arg(parser) -> None:
    parser.add_argument(
        "--platform", choices=PLATFORMS, default=None,
        help="JAX backend to run on (default: JAX's own choice)",
    )


def init(platform: str | None):
    """Select ``platform`` (if given), turn on the persistent compile cache
    and return the devices JAX will use.  Raises ``RuntimeError`` when the
    requested backend has no device."""
    import jax

    from constraint_solver_tpu.utils import compile_cache

    if platform is not None:
        # JAX names the NVIDIA backend "cuda"; its devices report "gpu".
        jax.config.update("jax_platforms", "cuda" if platform == "gpu" else platform)
    compile_cache.enable()
    devices = jax.devices()
    if platform is not None and devices[0].platform != platform:
        raise RuntimeError(f"--platform {platform}: JAX found {devices}")
    return devices
