"""pangenome_index_tpu: a pangenome indexing & query framework on the GPU.

A from-scratch JAX/XLA re-design of the capabilities of
`parsaeskandar/pangenome-index` (C++/OpenMP reference):

* r-index (run-length BWT + SA samples) with count / locate / LF / psi
  (reference: include/pangenome_index/r-index.hpp, src/r-index.cpp)
* FMD bidirectional extension + maximal-exact-match (MEM) finding
  (reference: include/pangenome_index/algorithm.hpp:625-757)
* Tag arrays mapping BWT positions -> pangenome graph positions
  (reference: include/pangenome_index/tag_arrays.hpp, src/tag_arrays.cpp)
* Index construction pipeline + per-chromosome sharding / merge
  (reference: src/build_tags.cpp, src/merge_tags.cpp)

Layout:
  formats/   on-disk codecs (.rl_bwt, sdsl structures, .ri, .tags, GBZ)
  models/    host-side index models (numpy) and device table layouts
  ops/       JAX device code (rank, LF, FMD, MEM, tag query)
  parallel/  mesh / sharding / distributed query & merge
  utils/     alphabet, config, timing
"""

__version__ = "0.1.0"


def load_rindex(path, use_mmap: bool = False):
    """Load a .ri r-index file (legacy or encoded format)."""
    from .formats.ri import load_file

    return load_file(path, use_mmap=use_mmap)


def load_tags(path, use_mmap: bool = False):
    """Load a .tags tag-array file (any of the three on-disk formats)."""
    from .formats.tags import load_tags_file

    return load_tags_file(path, use_mmap=use_mmap)


def load_gbz(path):
    """Load a GBZ graph container (simple-sds format)."""
    from .formats.gbz import load_gbz as _load

    return _load(path)


def build_index(text_lines, keep_sa: bool = True):
    """Build an r-index from newline-free sequence byte strings (native SA-IS
    when available, host rotation sort otherwise).

    NOTE: FMD-based MEM finding assumes the text contains both strands;
    include each sequence's reverse complement (the reference's bidirectional
    workflow) when serving find_mems."""
    from .formats.rlbwt import rlbwt_from_text
    from .models.rindex import build_rindex, build_rindex_from_sa

    try:
        from . import native

        if not native.available():
            raise RuntimeError
        bwt, da, sa_pos, seq_lengths = native.build_bwt_native(list(text_lines))
        idx = build_rindex_from_sa(rlbwt_from_text(bwt.tobytes()), da, sa_pos, seq_lengths)
        if keep_sa:
            idx.sa_seq, idx.sa_pos, idx.seq_lengths = da, sa_pos, seq_lengths
        return idx
    except Exception:
        from .models.oracle import oracle_from_lines

        o = oracle_from_lines(list(text_lines))
        return build_rindex(rlbwt_from_text(o.bwt.tobytes()), keep_sa=keep_sa)


def to_device(idx, dense: bool = True, **kw):
    """r-index -> device tables for the JAX query engine, on the serving
    device (an error without a GPU unless the CPU was requested)."""
    from .device import serving_device
    from .ops.tables import rindex_to_device

    serving_device()
    return rindex_to_device(idx, dense=dense, **kw)


def find_mems(tables, reads, min_len: int, min_occ: int, capacity: int = 64):
    """Batched MEM finding on device. reads: list of byte strings.
    Returns per-read lists of (start, end, bwt_start, size)."""
    import numpy as np

    from .ops.mems import find_mems_batch
    from .utils.alphabet import BYTE_TO_CODE

    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    res = find_mems_batch(tables, codes, lens, min_len, min_occ, capacity=capacity)
    s, e, b, z = (np.asarray(a) for a in (res.start, res.end, res.bwt_start, res.size))
    cnt = np.asarray(res.count)
    return [
        [(int(s[i, m]), int(e[i, m]), int(b[i, m]), int(z[i, m]))
         for m in range(min(int(cnt[i]), capacity))]
        for i in range(len(reads))
    ]
