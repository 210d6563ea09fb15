"""Distributed query engine: data-parallel reads x model-parallel index.

The full serving step (MEM finding over a read batch + tag lookup + global
stats) jitted over a ('data', 'model') mesh:

* reads are sharded over 'data' (each device slice runs its own MEM lanes)
* the r-index run table is sharded over 'model' by contiguous run ranges;
  every rank query inside the MEM state machine resolves with one psum over
  'model' (see parallel/sharding.py:distributed_rank6)
* per-batch statistics (total MEMs) reduce with a psum over 'data'

This is the device-mesh replacement for the reference's process-per-chromosome
+ filesystem sharding (SURVEY §2.1 items 4-5): the index shards live in device
memory across the mesh and the "merge" is a collective, not a file protocol.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.mems import MemResult, find_mems_impl
from ..ops.tables import RIndexTables, TagTables
from ..ops.tagquery import TagQueryResult, query_tags_batch
from .sharding import distributed_ckpt_rank6, distributed_rank6


def run_specs(t: RIndexTables) -> RIndexTables:
    """shard_map partition specs for the index tables: run-dimension arrays
    shard over 'model', scalars/small tables replicate. With a checkpoint
    table present, `ckpt` rows shard over 'model' (contiguous position
    ranges) and `cum` is the trimmed [1, 6] stub - replicated."""
    has_ckpt = t.ckpt is not None
    return RIndexTables(
        run_sym=P("model"), run_start=P("model"),
        cum=P() if has_ckpt else P("model", None),
        C=P(), samples=P(), last_sorted=P(), last_to_run=P(),
        n=P(), n_seq=P(), max_len=P(),
        ckpt=P("model", None) if has_ckpt else None,
        ckpt_super=P() if t.ckpt_super is not None else None,
    )


def _rank_provider(t_local: RIndexTables):
    """The model-sharded rank6 provider for this shard's table slice:
    checkpoint rows when present (one local gather + psum), else the
    binary-search run-table form."""
    if t_local.ckpt is not None:
        return lambda pos: distributed_ckpt_rank6(t_local.ckpt, pos,
                                                  axis="model",
                                                  super_base=t_local.ckpt_super)
    return lambda pos: distributed_rank6(
        t_local.run_start, t_local.run_sym, t_local.cum, pos, axis="model")


def _seed_in_specs(mer_m: int, sdict_m: int):
    """Trailing in_specs for the optional seed tiers: the dense table and
    sparse dictionary values replicate; per-read keys shard over 'data'."""
    specs = ()
    if mer_m:
        specs += (P(), P("data", None), P("data", None))
    if sdict_m:
        specs += (P(), P("data", None))
    return specs


def _seed_kwargs(mer_m: int, sdict_m: int, seed_args):
    kw = {}
    if mer_m:
        kw.update(mer_table=seed_args[0], mer_keys=seed_args[1],
                  mer_valid=seed_args[2], mer_m=mer_m)
        seed_args = seed_args[3:]
    if sdict_m:
        kw.update(sdict_vals=seed_args[0], sdict_idx=seed_args[1],
                  sdict_m=sdict_m)
    return kw


def make_distributed_mem_step(mesh: Mesh, capacity: int = 16,
                              tables: RIndexTables | None = None,
                              mer_m: int = 0, sdict_m: int = 0):
    """Returns a jitted step: (tables, codes, lengths, min_len, min_occ
    [, mer_table, mer_keys, mer_valid][, sdict_vals, sdict_idx])
    -> (MemResult sharded over 'data', total MEM count replicated).

    `tables` (a host-side template) selects the spec/provider for the
    checkpoint representation; mer_m > 0 adds the m-mer seed-table arguments
    (table replicated, per-read keys sharded over 'data'); sdict_m > 0 adds
    the sparse long-seed dictionary tier (values replicated, per-read row
    indices sharded over 'data' - ops/sparsedict.py)."""
    specs = run_specs(tables) if tables is not None else run_specs(
        RIndexTables(*(0,) * 10))
    seed_in = _seed_in_specs(mer_m, sdict_m)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, P("data", None), P("data"), P(), P(), *seed_in),
        out_specs=(jax.tree.map(lambda _: P("data"), MemResult(*(0,) * 6)), P()),
        check_vma=False,
    )
    def step(t_local: RIndexTables, codes, lengths, min_len, min_occ, *seed):
        res = find_mems_impl(t_local, codes, lengths, min_len, min_occ,
                             capacity=capacity,
                             rank6_fn=_rank_provider(t_local),
                             **_seed_kwargs(mer_m, sdict_m, seed))
        total = jax.lax.psum(res.count.sum(), "data")
        return res, total

    return jax.jit(step, static_argnames=())


def make_distributed_serving_step(mesh: Mesh, capacity: int = 16,
                                  tag_capacity: int = 32,
                                  tables: RIndexTables | None = None,
                                  mer_m: int = 0, sdict_m: int = 0):
    """The FULL serving step over the mesh: MEM finding (model-sharded rank
    via psum - checkpoint rows when the tables carry them) followed by tag
    lookups for every found MEM (tag tables replicated; find_mems.cpp:96-139
    semantics). Outputs are data-sharded; the total MEM count reduces over
    'data'. mer_m > 0 enables the m-mer seed table (replicated) with
    per-read keys sharded over 'data'; sdict_m > 0 the sparse long-seed
    dictionary tier (ops/sparsedict.py)."""
    specs = run_specs(tables) if tables is not None else run_specs(
        RIndexTables(*(0,) * 10))
    seed_in = _seed_in_specs(mer_m, sdict_m)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, jax.tree.map(lambda _: P(), TagTables(0, 0, 0)),
                  P("data", None), P("data"), P(), P(), *seed_in),
        out_specs=(jax.tree.map(lambda _: P("data"), MemResult(*(0,) * 6)),
                   jax.tree.map(lambda _: P("data"), TagQueryResult(*(0,) * 4)),
                   P()),
        check_vma=False,
    )
    def step(t_local, tt, codes, lengths, min_len, min_occ, *seed):
        res = find_mems_impl(t_local, codes, lengths, min_len, min_occ,
                             capacity=capacity,
                             rank6_fn=_rank_provider(t_local),
                             **_seed_kwargs(mer_m, sdict_m, seed))
        B, M = res.bwt_start.shape
        starts = res.bwt_start.reshape(B * M)
        ends = (res.bwt_start + res.size - 1).reshape(B * M)
        valid = (jnp.arange(M)[None, :] < res.count[:, None]).reshape(B * M)
        starts = jnp.where(valid, starts, 0)
        ends = jnp.where(valid, ends, 0)
        tq = query_tags_batch(tt, starts, ends, capacity=tag_capacity)
        tq = TagQueryResult(
            positions=tq.positions.reshape(B, M * tag_capacity),
            n_unique=jnp.where(valid, tq.n_unique, 0).reshape(B, M),
            n_runs=jnp.where(valid, tq.n_runs, 0).reshape(B, M),
            overflow=(tq.overflow & valid).reshape(B, M),
        )
        total = jax.lax.psum(res.count.sum(), "data")
        return res, tq, total

    return jax.jit(step)
