"""Distributed tag merge on the device mesh.

The reference's merge_tags is a 32-thread file-stream protocol with a condvar
turn ticket (merge_tags.cpp:250-266): per-chromosome tag streams are consumed
sequentially as whole-genome BWT rows arrive in order. The device-mesh form:
rows are sharded over the 'data' axis; every shard computes, for each of its
rows, the row's global rank WITHIN its component (local cumsum + one
all_gather of per-shard component counts = the cross-shard exclusive scan),
then gathers the tag from the replicated per-component streams. One
collective round total; no sequential consumption anywhere.

Equality with the host merge (core/merge.py) is tested on the two_contig
fixture across mesh shapes (tests/test_device_merge.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_device_merge(mesh: Mesh, n_components: int):
    """Returns a jitted merge: (comp_per_row [n] data-sharded,
    stream_flat [t], stream_offsets [n_components+1]) -> tag_per_row [n]
    data-sharded. Components are 0..n_components-1; rows with component -1
    (endmarkers) get tag 0 (merge_tags.cpp:620-624)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data"), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    def step(comp_local, stream_flat, stream_offsets):
        nloc = comp_local.shape[0]
        # per-component local ranks and counts
        onehot = (comp_local[None, :] == jnp.arange(n_components)[:, None])  # [C, nloc]
        local_prefix = jnp.cumsum(onehot, axis=1) - onehot  # exclusive
        counts = onehot.sum(axis=1)  # [C]
        # cross-shard exclusive scan of counts over the data axis
        all_counts = jax.lax.all_gather(counts, "data")  # [shards, C]
        me = jax.lax.axis_index("data")
        prev = jnp.where(jnp.arange(all_counts.shape[0])[:, None] < me, all_counts, 0).sum(axis=0)
        # global rank of each local row within its component
        c_idx = jnp.clip(comp_local, 0, n_components - 1)
        lane = jnp.arange(nloc)
        grank = prev[c_idx] + local_prefix[c_idx, lane]
        tag = stream_flat[jnp.clip(stream_offsets[c_idx] + grank, 0, stream_flat.shape[0] - 1)]
        return jnp.where(comp_local < 0, 0, tag)

    return jax.jit(step)


def merge_tags_device(mesh: Mesh, comp_per_row: np.ndarray,
                      comp_streams: dict[int, np.ndarray]):
    """Convenience wrapper: dense-relabels components, pads rows to the mesh,
    runs the sharded merge, returns tag-per-row (host array)."""
    comps = sorted(comp_streams)
    relabel = {c: i for i, c in enumerate(comps)}
    cpr = np.array([relabel.get(int(c), -1) for c in comp_per_row], np.int32)
    n = len(cpr)
    shards = mesh.shape["data"]
    pad = (-n) % shards
    cpr_p = np.concatenate((cpr, np.full(pad, -1, np.int32)))
    flat = np.concatenate([comp_streams[c] for c in comps]).astype(np.int64)
    offsets = np.zeros(len(comps) + 1, np.int64)
    np.cumsum([len(comp_streams[c]) for c in comps], out=offsets[1:])
    step = make_device_merge(mesh, len(comps))
    with mesh:
        out = step(jnp.asarray(cpr_p), jnp.asarray(flat), jnp.asarray(offsets))
    return np.asarray(out)[:n]
