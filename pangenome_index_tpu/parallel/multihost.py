"""Multi-host serving and merge over the network between hosts and the
links between the devices of a host.

The reference's multi-machine story is per-chromosome processes plus files
(README.md:103-133, merge_tags). The device-mesh equivalent:

* `init_distributed()` - `jax.distributed.initialize` from standard env
  (COORDINATOR_ADDRESS / process ids), giving one global mesh over all hosts.
* `global_read_batch(...)` - each host loads its local shard of the read
  batch; `jax.make_array_from_process_local_data` assembles the global
  data-sharded array (reads cross the network only at input).
* the serving step itself (`parallel/engine.py`) is unchanged: the `data`
  axis spans hosts; index shards live per device over `model`; rank psums
  stay within a host.
* `merge_tags` cross-host: each host computes its components' (row, tag)
  streams locally; the global RLE boundary fix-up needs only each shard's
  first/last run - one tiny allgather.

Only the single-process degenerate path is exercised by tests here (no
multi-host hardware in CI); the entry points follow the standard
jax.distributed recipe so a pod deployment is configuration, not code.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or standard environment
    variables; no-op for single-process runs."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or int(os.environ.get("NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("PROCESS_ID", "0")),
    )


def global_mesh(n_model: int = 1) -> Mesh:
    """A (data, model) mesh over all devices of all processes."""
    devs = np.asarray(jax.devices())
    n_data = devs.size // n_model
    return Mesh(devs[: n_data * n_model].reshape(n_data, n_model), ("data", "model"))


def put_global(mesh: Mesh, pytree, specs):
    """Place a host-replicated pytree (e.g. the index tables every process
    loaded from the same files) onto a multi-process mesh under the given
    PartitionSpecs: each process contributes exactly its addressable shards
    (jax.make_array_from_callback), so no host ships bytes it does not own."""
    def put(x, spec):
        x = np.asarray(x)
        s = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    return jax.tree.map(put, pytree, specs)


def global_read_batch(mesh: Mesh, local_codes: np.ndarray, local_lengths: np.ndarray):
    """Assemble a globally data-sharded read batch from per-process shards."""
    sharding = NamedSharding(mesh, P("data", None))
    lsharding = NamedSharding(mesh, P("data"))
    codes = jax.make_array_from_process_local_data(sharding, local_codes)
    lengths = jax.make_array_from_process_local_data(lsharding, local_lengths)
    return codes, lengths


def stitch_rle_shards(shards: list[tuple[np.ndarray, np.ndarray]]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-host RLE outputs over consecutive row ranges into one global
    run list: when a shard's first run continues the previous shard's last run
    (equal value), the lengths are summed - the cross-host boundary fix-up of
    the distributed merge (each host ships only its run list; the reference's
    equivalent is the sequential first-run fix-up at merge_tags.cpp:640-684).
    Empty shards (hosts whose row range was empty) are skipped."""
    vals_out: list[np.ndarray] = []
    lens_out: list[np.ndarray] = []
    prev_val, prev_len = None, 0
    for vals, lens in shards:
        if len(vals) == 0:
            continue
        lens = np.asarray(lens, np.int64)
        if prev_val is not None and vals[0] == prev_val:
            lens = lens.copy()
            lens[0] += prev_len
        elif prev_val is not None:
            vals_out.append(np.array([prev_val], np.int64))
            lens_out.append(np.array([prev_len], np.int64))
        vals_out.append(np.asarray(vals[:-1], np.int64))
        lens_out.append(lens[:-1])
        prev_val, prev_len = int(vals[-1]), int(lens[-1])
    if prev_val is not None:
        vals_out.append(np.array([prev_val], np.int64))
        lens_out.append(np.array([prev_len], np.int64))
    if not vals_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(vals_out), np.concatenate(lens_out)
