"""The serving device, its memory budget, and the XLA compile cache.

Every device engine (`--engine device`, the mesh path, the seed-table and
dictionary builds, bench.py, chip_smoke.py) asks this module for its device,
so a machine without a GPU fails loudly instead of serving from the CPU. The
CPU backend is accepted only when it was asked for (`JAX_PLATFORMS=cpu` or
`jax_platforms`), which is how the tests run the device code paths.
"""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass

#: root of the checkout (the compile cache lives under it)
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

#: largest seed table the auto policy picks: every +1 of m removes one
#: extension per seeded step, and 4^14 rows is the deepest table measured
MAX_MER_M = 14


def cpu_requested() -> bool:
    """True when JAX was told to use the CPU platform (`jax_platforms`, which
    JAX initialises from JAX_PLATFORMS)."""
    import jax

    plats = jax.config.jax_platforms or ""
    return "cpu" in [p.strip() for p in plats.lower().split(",")]


def serving_device():
    """The device the engines run on: the first GPU, or the CPU when the CPU
    platform was requested. Anything else is an error."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "gpu" or (dev.platform == "cpu" and cpu_requested()):
        return dev
    raise RuntimeError(
        f"no GPU found (JAX default device: {dev.platform} "
        f"{dev.device_kind}); set JAX_PLATFORMS=cpu to run the device "
        f"engines on the CPU")


def serving_devices() -> list:
    """All devices of the serving platform (for meshes)."""
    import jax

    return jax.devices(serving_device().platform)


@dataclass(frozen=True)
class MemoryBudget:
    """Device-memory caps, all derived from one number: the bytes the JAX
    allocator may use on the serving device."""

    bytes_limit: int

    @property
    def sdict_resident_max(self) -> int:
        """Largest long-seed dictionary value table kept resident beside the
        checkpoint table and the dense seed table."""
        return self.bytes_limit * 3 // 8

    @property
    def sdict_build_max(self) -> int:
        """Largest [C, 8] frontier state (double-buffered) of the device
        dictionary build."""
        return self.bytes_limit * 3 // 16

    @property
    def mer_cache_max(self) -> int:
        """Seed tables larger than this are rebuilt on the device in every
        process instead of being fetched, written to and read back from an
        npz cache next to the index."""
        return self.bytes_limit // 64

    def mer_cap(self, itemsize: int) -> int:
        """Deepest dense seed table (4^m x 3 entries of `itemsize` bytes)
        that takes at most a quarter of the budget, up to MAX_MER_M."""
        m = MAX_MER_M
        while m > 4 and 4**m * 3 * itemsize > self.bytes_limit // 4:
            m -= 1
        return m


def memory_budget(device=None) -> MemoryBudget:
    """The budget of `device` (default: the serving device). The CPU backend
    reports no allocator limit; its budget is the host's physical memory."""
    dev = device if device is not None else serving_device()
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit is None:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return MemoryBudget(int(limit))


def card_info() -> str:
    """The GPU's name and power limit as nvidia-smi reports them (one line
    per card), or why they could not be read. Touches no JAX state."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def device_record(dev=None) -> dict:
    """What every result names: the serving device as JAX reports it, how
    many of its platform there are, its allocator limit, and the card's name
    and power limit."""
    import jax

    dev = dev if dev is not None else serving_device()
    return {"jax": jax.__version__, "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices(dev.platform)),
            "bytes_limit": (dev.memory_stats() or {}).get("bytes_limit"),
            "card": card_info()}


def setup_compile_cache() -> None:
    """Persistent XLA compile cache. Where JAX_COMPILATION_CACHE_DIR is set,
    JAX reads it itself and nothing is set here; otherwise the cache lives
    at a fixed path in the checkout (the path is part of the cache key)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_ROOT / ".jax_cache"))
