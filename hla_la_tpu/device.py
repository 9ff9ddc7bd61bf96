"""The accelerator, described and chosen for in one place.

Every device-path decision reads from here: what the device is, where the
persistent compile cache lives, which banded-NW forward runs for a shape,
and how read batches are bucketed.  Every device computation is plain
JAX that XLA compiles for the platform; no hand-written kernel remains.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# Backends of the CLI/pipeline that run on the accelerator.
DEVICE_BACKENDS = ("jax", "sharded")

# Device NW serves shapes up to this many band cells per read, (L+1)*W:
# short reads (L <= 256 at W=32).  Longer shapes (long-read mode, W=256)
# run the host NW.
DEVICE_NW_MAX_CELLS = 15_625

# Device NW batch: larger inputs are sliced at DEVICE_BATCH and every
# slice is padded up to it, so one compiled shape serves every batch.
# From a sweep on one H100 at L=128, W=32 (PERF.md): the XLA scan with
# its transfers served 0.17M reads/s at B=1024, 0.48M at 4096 and 0.41M
# at 16384 (the [B, L+1, W] pointer readback grows super-linearly past
# 4096).
DEVICE_BATCH = 4096
HOST_MIN_BATCH = 64
HOST_MAX_BATCH = 65536


def gpu_name_and_power() -> str:
    """`nvidia-smi` name and power limit of the card(s), or "" where
    there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return ""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return r.stdout.strip()


def describe() -> dict:
    """Platform, device_kind and count as JAX reports them, plus the
    card's name and power limit."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power()}


def device_line(info: dict | None = None) -> str:
    info = info or describe()
    smi = info["nvidia_smi"].replace("\n", " | ") or "no nvidia-smi"
    return (f"device: platform={info['platform']} kind={info['kind']} "
            f"count={info['count']} ({smi})")


def setup_compile_cache() -> str:
    """Persistent compile cache: where JAX_COMPILATION_CACHE_DIR says
    (JAX reads that variable itself, so nothing is set), else a fixed
    directory inside the checkout.  Call before any compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def _platform() -> str:
    import jax
    return jax.default_backend()


def is_device_nw_shape(L: int, W: int) -> bool:
    return (L + 1) * W <= DEVICE_NW_MAX_CELLS


@functools.lru_cache(maxsize=32)
def nw_forward(L: int, W: int):
    """The device banded-NW forward for an (L, W) shape: the XLA scan of
    ops/banded_nw on every platform.  A Pallas kernel for the GPU was
    7.5-9.4x faster per call on the device but not measurably faster end
    to end (PERF.md), so it was not kept."""
    from .ops.banded_nw import make_jax_banded_nw
    return make_jax_banded_nw(L, W)


def batch_bucket(n: int, platform: str | None = None) -> int:
    """Padded batch size for n <= max_batch() NW jobs: DEVICE_BATCH on an
    accelerator, a power of two of at least HOST_MIN_BATCH on the CPU."""
    platform = platform or _platform()
    if platform != "cpu":
        assert n <= DEVICE_BATCH, n
        return DEVICE_BATCH
    return max(HOST_MIN_BATCH, 1 << max(n - 1, 0).bit_length())


def max_batch(platform: str | None = None) -> int:
    """Jobs per NW call before the aligner slices its input."""
    platform = platform or _platform()
    return HOST_MAX_BATCH if platform == "cpu" else DEVICE_BATCH
