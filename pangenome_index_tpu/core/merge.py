"""merge_tags: combine per-chromosome tag arrays into whole-genome tags.

The reference's "distributed" layer (src/merge_tags.cpp, 869 LoC): 32 threads
walk 500-run windows of the whole-genome r-index with locateNext, route every
BWT position to its component's tag file through a condvar turn-ticket
protocol, and re-run-length-encode. The correctness invariant it exploits:
restricted to one component, whole-genome BWT rows appear in the same
relative order as that component's own BWT rows, so each per-chromosome tag
stream is consumed strictly sequentially.

Here the same invariant becomes pure array ops:

  1. seq-of-row for every BWT row via run-parallel locateNext chains
     (lanes = runs, replacing merge_tags.cpp:307-356)
  2. component routing: union-find over GBWT record edges
     (node_to_component, algorithm.hpp:600-618) + first path node per
     sequence (merge_tags.cpp:508-515)
  3. one stable counting pass assigns stream indices; a gather materializes
     tag-per-row; endmarker rows get tag (0,0,0) (merge_tags.cpp:620-624)
  4. RLE + 511-splitting + the compact width rule 11 + bits(max node id)
     (merge_tags.cpp:630-638)
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..formats.gbz import GBZ
from ..models.rindex import RIndex
from ..models.tagarray import TagArray
from .tagbuild import rle


def seq_of_rows(idx: RIndex) -> np.ndarray:
    """Sequence id of every BWT row via run-parallel locateNext chains."""
    n, r = idx.n, idx.n_runs
    out = np.zeros(n, dtype=np.int64)
    cur = idx.samples.copy()
    lens = idx.run_len
    max_len = int(lens.max())
    active = np.ones(r, dtype=bool)
    t = 0
    while active.any():
        rows = idx.run_start[active] + t
        out[rows] = cur[active] // idx.max_len
        t += 1
        active = active & (lens > t)
        live = active.copy()
        if live.any():
            cur_live = cur[live]
            nxt = idx.locate_next(cur_live)
            cur[live] = nxt
    return out


class NodeComponents:
    """Array-backed node -> component-representative map (smallest member
    graph node id), dict-like for the routing lookups. Computed from the
    decoded record table's successor edges in one vectorized pass
    (formats/gbwt_table.component_labels, replacing the per-record Python
    union-find; semantics of gbwtgraph::weakly_connected_components /
    algorithm.hpp:600-618)."""

    def __init__(self, gbz: GBZ):
        self.first = int(gbz.graph.node_ids[0])
        self.labels = gbz.index.table().component_labels(
            self.first, len(gbz.graph.node_ids))

    def __getitem__(self, node_id: int) -> int:
        return int(self.labels[int(node_id) - self.first])

    def __contains__(self, node_id: int) -> bool:
        return 0 <= int(node_id) - self.first < len(self.labels)


def node_components(gbz: GBZ) -> NodeComponents:
    """Weakly-connected components over the graph's edges (successor lists
    from GBWT records), smallest node id as representative."""
    return NodeComponents(gbz)


def _seq_components(gbz: GBZ, comp_of_node: NodeComponents, n_seq: int) -> np.ndarray:
    """Component of each text sequence via the first node of its path: one
    vectorized LF on record 0 (merge_tags.cpp:508-515 walks the whole path;
    the first visit suffices to identify the component)."""
    from .tagbuild import text_seq_map

    seq_map = np.array(text_seq_map(gbz, n_seq), np.int64)
    firsts = gbz.index.table().first_nodes(seq_map)
    return comp_of_node.labels[(firsts >> 1) - comp_of_node.first]


def merge_tags(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray]) -> TagArray:
    """comp_tags: component representative -> that component's tag array
    (algorithm coordinates: positions for the component's non-endmarker rows
    in its own BWT order)."""
    n, n_seq = idx.n, idx.n_seq
    comp_of_node = node_components(gbz)
    seq_comp = _seq_components(gbz, comp_of_node, n_seq)

    srows = seq_of_rows(idx)
    comp_per_row = seq_comp[srows]

    comps = sorted(comp_tags)
    tag_per_row = np.zeros(n, dtype=np.int64)
    rows = np.arange(n_seq, n)
    crows = comp_per_row[rows]
    for c in comps:
        mask = crows == c
        stream = comp_tags[c]
        per_pos = np.repeat(stream.pos_enc, stream.run_lengths())
        if mask.sum() != len(per_pos):
            raise ValueError(
                f"component {c}: {mask.sum()} rows but stream covers {len(per_pos)}"
            )
        tag_per_row[rows[mask]] = per_pos
    vals, lens = rle(tag_per_row)
    return TagArray.from_runs(vals, lens)


class _StreamCursor:
    """Sequential consumer of one component's run-level tag stream.

    Replaces the reference FileReader's 1M-run ring buffer + turn-ticket
    protocol (merge_tags.cpp:42-284): the BWT-order invariant means each
    stream is only ever read forward, so a cursor into the run-level arrays
    suffices; `take(k)` materializes exactly the k consumed positions."""

    def __init__(self, tags: TagArray):
        self.vals = tags.pos_enc
        self.cum = np.concatenate(([0], np.cumsum(tags.run_lengths())))
        self.consumed = 0

    @property
    def remaining(self) -> int:
        return int(self.cum[-1]) - self.consumed

    def take(self, k: int) -> np.ndarray:
        a, b = self.consumed, self.consumed + int(k)
        if b > self.cum[-1]:
            raise ValueError(
                f"tag stream exhausted: need {b} positions, have {self.cum[-1]}")
        i0 = int(np.searchsorted(self.cum, a, side="right")) - 1
        i1 = int(np.searchsorted(self.cum, b, side="left"))
        reps = np.minimum(self.cum[i0 + 1 : i1 + 1], b) - np.maximum(self.cum[i0:i1], a)
        self.consumed = b
        return np.repeat(self.vals[i0:i1], reps)


def merge_tags_streamed(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray],
                        window: int = 1 << 22) -> TagArray:
    """Bounded-memory merge: identical output to `merge_tags`, but the BWT is
    walked in run batches of ~`window` rows (lane-per-run locateNext chains
    restricted to the batch), each component stream is consumed through a
    cursor, and runs are RLE-carried across batch boundaries. Peak memory is
    O(window + total output runs) - no per-position whole-genome array
    (the reference streams with 500-run jobs + ring buffers,
    merge_tags.cpp:288-409; same invariant, array form)."""
    n, n_seq, r = idx.n, idx.n_seq, idx.n_runs
    comp_of_node = node_components(gbz)
    seq_comp = _seq_components(gbz, comp_of_node, n_seq)
    # values may be TagArrays (wrapped in an in-memory cursor) or any
    # cursor-like object with take(k)/remaining - e.g. the file-backed
    # formats/tags_stream.PositionCursor that keeps only O(chunk) resident
    cursors = {c: (_StreamCursor(t) if isinstance(t, TagArray) else t)
               for c, t in comp_tags.items()}

    out_vals: list[np.ndarray] = []
    out_lens: list[np.ndarray] = []
    prev_val, prev_len = None, 0
    j0 = 0
    while j0 < r:
        row0 = int(idx.run_start[j0])
        j1 = int(np.searchsorted(idx.run_start, row0 + window, side="left"))
        j1 = max(j1, j0 + 1)
        row1 = int(idx.run_start[j1]) if j1 < r else n
        W = row1 - row0
        # sequence-of-row for the batch rows via lane-per-run locateNext
        lens_b = idx.run_len[j0:j1]
        starts_b = idx.run_start[j0:j1] - row0
        cur = idx.samples[j0:j1].copy()
        srows_w = np.zeros(W, dtype=np.int64)
        active = np.ones(j1 - j0, dtype=bool)
        t = 0
        while active.any():
            rows = starts_b[active] + t
            srows_w[rows] = cur[active] // idx.max_len
            t += 1
            active = active & (lens_b > t)
            if active.any():
                cur[active] = idx.locate_next(cur[active])
        # route rows to component streams; endmarker rows tag 0 (merge_tags.cpp:620-624)
        tag_w = np.zeros(W, dtype=np.int64)
        body = np.arange(W)[row0 + np.arange(W) >= n_seq]
        comp_w = seq_comp[srows_w[body]]
        for c in np.unique(comp_w):
            if int(c) not in cursors:
                raise ValueError(f"no tag stream for component {c}")
            mask = comp_w == c
            tag_w[body[mask]] = cursors[int(c)].take(int(mask.sum()))
        vals_w, lens_w = rle(tag_w)
        if prev_val is not None and len(vals_w) and vals_w[0] == prev_val:
            lens_w = lens_w.copy()
            lens_w[0] += prev_len
        elif prev_val is not None:
            out_vals.append(np.array([prev_val], np.int64))
            out_lens.append(np.array([prev_len], np.int64))
        if len(vals_w):
            out_vals.append(vals_w[:-1])
            out_lens.append(lens_w[:-1])
            prev_val, prev_len = int(vals_w[-1]), int(lens_w[-1])
        j0 = j1
    if prev_val is not None:
        out_vals.append(np.array([prev_val], np.int64))
        out_lens.append(np.array([prev_len], np.int64))
    for c, cur_ in cursors.items():
        if cur_.remaining:
            raise ValueError(f"component {c}: {cur_.remaining} unconsumed tag positions")
    return TagArray.from_runs(np.concatenate(out_vals), np.concatenate(out_lens))


def merge_tags_on_device(gbz: GBZ, idx: RIndex, comp_tags: dict[int, TagArray],
                         mesh=None) -> TagArray:
    """Device-mesh merge: identical output to `merge_tags`, computed by the
    sharded all_gather scan step (parallel/merge.py) - rows sharded over
    'data', one collective round, no sequential stream consumption. The
    component routing (seq-of-row + per-sequence component) stays host-side;
    the per-row global-rank + gather runs on the mesh of every serving
    device. Device-resident deployment path (~16 B/row for comp + tag
    lanes); the bounded-memory host path remains `merge_tags_streamed`."""
    from ..device import serving_devices
    from ..parallel.merge import merge_tags_device
    from ..parallel.sharding import make_mesh

    if mesh is None:
        devices = serving_devices()
        mesh = make_mesh(len(devices), 1, devices)
    n, n_seq = idx.n, idx.n_seq
    comp_of_node = node_components(gbz)
    seq_comp = _seq_components(gbz, comp_of_node, n_seq)
    comp_per_row = seq_comp[seq_of_rows(idx)].astype(np.int64)
    comp_per_row[:n_seq] = -1  # endmarker rows -> tag 0 (merge_tags.cpp:620-624)
    streams = {}
    for c, t in comp_tags.items():
        per_pos = np.repeat(t.pos_enc, t.run_lengths())
        expect = int((comp_per_row == c).sum())
        if expect != len(per_pos):
            raise ValueError(
                f"component {c}: {expect} rows but stream covers {len(per_pos)}")
        streams[int(c)] = per_pos
    tag_per_row = merge_tags_device(mesh, comp_per_row, streams)
    vals, lens = rle(tag_per_row)
    return TagArray.from_runs(vals, lens)


def merge_tags_pipeline(gbz_path: str, ri_path: str, tags_dir: str, output: str,
                        window: int = 1 << 22, chunk_runs: int = 1 << 20,
                        engine: str = "host") -> int:
    from ..formats import tags as tagfmt
    from ..formats import ri as rifmt
    from ..formats.gbz import load_gbz

    from ..formats.tags_stream import PositionCursor, TagRunStream

    gbz = load_gbz(gbz_path)
    idx = rifmt.load_file(ri_path)
    comp_of_node = node_components(gbz)
    comp_tags: dict[int, PositionCursor] = {}
    for name in sorted(os.listdir(tags_dir)):
        if not name.endswith(".tags"):
            continue
        # any of the three tag formats (auto-detected), consumed through a
        # chunked file cursor so inputs stay O(chunk) resident - the array
        # analog of the reference's 1M-run ring buffers
        # (FileReader::refill_tags, merge_tags.cpp:221-245)
        stream = TagRunStream(os.path.join(tags_dir, name), chunk_runs=chunk_runs)
        first_node = stream.peek_first_pos() >> 11
        comp = comp_of_node[first_node]
        if engine == "device":
            # device-resident path: the sharded scan-merge consumes the whole
            # run-level stream at once (no cursor protocol to honor)
            comp_tags[comp] = tagfmt.load_tags_file(os.path.join(tags_dir, name))
        else:
            comp_tags[comp] = PositionCursor(stream)
        print(f"{name}: component {comp} ({stream.fmt} stream)", file=sys.stderr)
    if engine == "device":
        merged = merge_tags_on_device(gbz, idx, comp_tags)
    else:
        merged = merge_tags_streamed(gbz, idx, comp_tags, window=window)
    with open(output, "wb") as fh:
        fh.write(tagfmt.write_compressed_sdsl(
            merged, width=11 + max(int(n) for n in gbz.graph.node_ids).bit_length()))
    print(f"merge-tags: {merged.n_runs} runs covering {merged.total} positions",
          file=sys.stderr)
    return 0
