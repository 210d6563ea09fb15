"""End-to-end demo: synthetic pangenome graph -> GBZ -> indexes -> serving.

Runs on the GPU, or on the CPU with JAX_PLATFORMS=cpu; uses only this
framework - no external bioinformatics tools.

    python examples/end_to_end.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import pangenome_index_tpu as px
from pangenome_index_tpu.core.gbwt_build import random_pangenome_gbz
from pangenome_index_tpu.core.tagbuild import build_tags
from pangenome_index_tpu.formats.gbz import node_seq
from pangenome_index_tpu.formats.gbz_write import save_gbz
from pangenome_index_tpu.ops.tables import tags_to_device
from pangenome_index_tpu.ops.tagquery import query_tags_batch


def main():
    rng = np.random.default_rng(0)

    # 1. a variation graph with 3 diploid-ish haplotypes (both strands)
    gbz = random_pangenome_gbz(rng, n_nodes=60, n_paths=3)
    with tempfile.TemporaryDirectory() as d:
        save_gbz(gbz, os.path.join(d, "demo.gbz"))
        print(f"graph: {sum(1 for s in gbz.graph.sequences if s)} nodes, "
              f"{gbz.index.sequences} sequences (GBZ written)")

    # 2. haplotype text + r-index
    lines = [b"".join(node_seq(gbz, n >> 1, bool(n & 1)) for n in gbz.index.extract(i))
             for i in range(gbz.index.sequences)]
    idx = px.build_index(lines)
    print(f"index: BWT size {idx.n}, {idx.n_runs} runs")

    # 3. tag array (BWT position -> graph position)
    tags = build_tags(gbz, idx)
    print(f"tags: {tags.n_runs} runs covering {tags.total} positions")

    # 4. serve: MEMs for reads spliced from two haplotypes, then graph positions
    tables = px.to_device(idx)
    tt = tags_to_device(tags)
    read = lines[0][:25] + lines[2][10:35]
    mems = px.find_mems(tables, [read], min_len=12, min_occ=1)[0]
    print(f"read of {len(read)} bp -> {len(mems)} MEMs")
    import jax.numpy as jnp

    for start, end, bwt_start, size in mems:
        q = query_tags_batch(tt, jnp.asarray([bwt_start - idx.n_seq], tt.bwt_start.dtype),
                             jnp.asarray([bwt_start + size - 1 - idx.n_seq], tt.bwt_start.dtype))
        hits = np.asarray(q.positions[0][: int(q.n_unique[0])])
        spots = [(int(h) >> 11, bool((int(h) >> 10) & 1), int(h) & 0x3FF) for h in hits]
        print(f"  MEM [{start},{end}) x{size}: graph positions {spots[:4]}"
              + (" ..." if len(spots) > 4 else ""))


if __name__ == "__main__":
    main()
