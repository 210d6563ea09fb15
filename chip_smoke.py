"""Smoke run of the whole panidx pipeline on the GPU, checked end to end.

Generates a depth-90 synthetic pangenome from a seed (a 1.25 Mbp backbone x
90 haplotypes, both strands: 225M BWT rows), indexes it through the `panidx`
CLI, and serves 16,384 reads of 150 bp at 1% errors with aligner seeding
settings (min_len=31, min_occ=5; the m=14 seed table and the s=30 long-seed
dictionary resident on the card). Every device engine's output is compared
byte for byte with its native or host twin: find-mems, query-tags,
build-sdict, build-bwt and merge-tags. Then it measures device reads/s,
compile time, peak device memory and the LF-step rate of the plain
checkpoint gather.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # sharded serving + merge on 4 GPUs

With --four-cards only the four-card paths run (find-mems --mesh 1x4 and
4x1, merge-tags --engine device), each against its one-card or host twin,
on a smaller index.

This process never touches JAX: every step that does runs as a child, one
at a time, so one process at a time holds the card. The last line of
stdout is {"ok": true, "device": {...}} on success; any failed phase exits
non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"
#: per-child time limit; the whole run must end within 20 minutes
STEP_TIMEOUT = 900
MIN_LEN, MIN_OCC = 31, 5


class PhaseError(RuntimeError):
    pass


@dataclass(frozen=True)
class Sizes:
    base_len: int      # serving graph backbone (bp)
    n_haps: int        # haplotypes (each path in both orientations)
    n_reads: int       # served reads (read_len bp, 1% errors)
    read_len: int
    n_exact: int       # error-free reads for query-tags
    bwt_base_len: int  # build-bwt graph backbone (x n_haps forward texts)
    merge_base_len: int  # merge-tags components' backbone
    merge_haps: int
    merge_comps: int


FULL = Sizes(base_len=1_250_000, n_haps=90, n_reads=16384, read_len=150,
             n_exact=2048, bwt_base_len=40_000, merge_base_len=200_000,
             merge_haps=16, merge_comps=3)
#: the four-card phase serves a smaller index: it tests the mesh paths, and
#: a four-card call costs four times as much per second
FOUR = Sizes(base_len=250_000, n_haps=90, n_reads=16384, read_len=150,
             n_exact=0, bwt_base_len=0, merge_base_len=200_000,
             merge_haps=16, merge_comps=4)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


class Smoke:
    """Runs the steps of one smoke run in `work`, each CLI step in a child
    process, and keeps per-step wall and compile times."""

    def __init__(self, work: pathlib.Path, env: dict | None = None):
        self.work = work
        self.env = dict(os.environ if env is None else env)
        self.env["PYTHONPATH"] = str(REPO)
        self.steps: list[dict] = []
        #: the card's name and power limit, named beside every number
        self.card = ""

    def path(self, name: str) -> str:
        return str(self.work / name)

    def err(self, label: str) -> str:
        """The stderr a step wrote."""
        return pathlib.Path(self.path(f"{label.replace(' ', '_')}.err")) \
            .read_text(errors="replace")

    def run(self, label: str, argv: list[str], stdout: str | None = None,
            report: str | None = None) -> dict:
        """Run one child; raise PhaseError unless it exits 0."""
        t0 = time.perf_counter()
        out = open(self.path(stdout), "wb") if stdout else subprocess.DEVNULL
        try:
            with open(self.path(f"{label.replace(' ', '_')}.err"), "wb") as err:
                r = subprocess.run([sys.executable, *argv], cwd=self.work,
                                   env=self.env, stdout=out, stderr=err,
                                   timeout=STEP_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise PhaseError(f"{label}: timed out after {STEP_TIMEOUT}s")
        finally:
            if stdout:
                out.close()
        rec = {"step": label, "wall_s": time.perf_counter() - t0}
        if report and os.path.exists(self.path(report)):
            with open(self.path(report)) as fh:
                rec.update(json.load(fh))
        self.steps.append(rec)
        if r.returncode != 0:
            raise PhaseError(f"{label}: exit {r.returncode}\n"
                             f"{self.err(label)[-3000:]}")
        extra = ""
        if "compile_s" in rec:
            extra = (f", XLA compile {rec['compile_s']:.1f} s, peak device "
                     f"bytes {rec['peak_bytes']}")
        on = f" [{self.card}]" if self.card else ""
        say(f"{label}: {rec['wall_s']:.1f} s{extra}{on}")
        return rec

    def cli(self, label: str, args: list[str], stdout: str | None = None,
            device: bool = False) -> dict:
        """A `panidx` command; device commands run under the child wrapper
        that records XLA compile seconds and peak device memory."""
        if not device:
            return self.run(label, ["-m", "pangenome_index_tpu.cli", *args],
                            stdout)
        report = f"{label.replace(' ', '_')}.json"
        return self.run(label, [str(REPO / "chip_smoke.py"), "--child",
                                report, "--", *args], stdout, report)


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def strip_timing(data: bytes) -> bytes:
    """find-mems stdout without its two trailing timing lines."""
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) < 2 or not all(l.startswith(b"Total time") for l in lines[-2:]):
        raise PhaseError("find-mems output lacks its two timing lines")
    return b"\n".join(lines[:-2])


def same_bytes(what: str, a: bytes, b: bytes) -> None:
    if a != b:
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        raise PhaseError(f"{what}: outputs differ at byte {n} "
                         f"({len(a)} vs {len(b)} bytes)")
    say(f"{what}: byte-identical ({len(a)} bytes)")


def same_arrays(what: str, a_path: str, b_path: str) -> None:
    """Elementwise equality of two npz artifacts (keys, vals)."""
    import numpy as np

    with np.load(a_path) as a, np.load(b_path) as b:
        for k in ("keys", "vals"):
            if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
                raise PhaseError(f"{what}: '{k}' differs")
        say(f"{what}: equal ({len(a['keys'])} entries)")


# ---------------------------------------------------------------- phases


def phase_identify(sm: Smoke, want_count: int) -> dict:
    """(a) The card as JAX and nvidia-smi see it; fails without a GPU."""
    sm.run("identify", [str(REPO / "chip_smoke.py"), "--probe", "probe.json"])
    with open(sm.path("probe.json")) as fh:
        info = json.load(fh)
    cards = info["card"].splitlines() or [""]
    sm.card = cards[0] + (f" (x{len(cards)})" if len(cards) > 1 else "")
    say(f"jax {info['jax']}: {info['count']} x {info['platform']} "
        f"'{info['kind']}', bytes_limit {info['bytes_limit']}")
    say(f"card (name, power limit): {info['card']}")
    if info["platform"] != "gpu":
        raise PhaseError(f"JAX found no GPU (platform {info['platform']})")
    if info["count"] < want_count:
        raise PhaseError(f"need {want_count} GPUs, JAX sees {info['count']}")
    return info


def phase_native(sm: Smoke) -> None:
    """(b) Build the native library from the committed sources."""
    sm.run("native build", ["-m", "pangenome_index_tpu.native"])


def phase_dataset(sm: Smoke, sz: Sizes, seed: int = 7) -> None:
    """(c) The serving graph, its reads, and the exact reads for query-tags."""
    from pangenome_index_tpu.formats.gbz_write import save_gbz
    from pangenome_index_tpu.utils.synth import synth_graph_gbz, synth_reads

    t0 = time.perf_counter()
    gbz, lines = synth_graph_gbz(sz.base_len, sz.n_haps, seed=seed)
    save_gbz(gbz, sm.path("g.gbz"))
    reads = synth_reads(lines, sz.n_reads, sz.read_len, error_rate=0.01,
                        seed=seed + 1)
    with open(sm.path("reads.txt"), "wb") as fh:
        fh.write(b"\n".join(reads) + b"\n")
    if sz.n_exact:
        exact = synth_reads(lines, sz.n_exact, sz.read_len, error_rate=0.0,
                            seed=seed + 2)
        with open(sm.path("exact.txt"), "wb") as fh:
            fh.write(b"\n".join(exact) + b"\n")
    sm.steps.append({"step": "dataset", "wall_s": time.perf_counter() - t0})
    say(f"dataset: {sz.base_len} bp x {sz.n_haps} haplotypes, "
        f"{sz.n_reads} reads ({time.perf_counter() - t0:.1f} s)")


def phase_index(sm: Smoke, host_sdict: bool = True) -> None:
    """(d) The index through the CLI; the device dictionary build against
    the host build."""
    sm.cli("extract-text", ["extract-text", "g.gbz", "-o", "g.txt"])
    sm.cli("build-bwt", ["build-bwt", "g.txt", "g.rl_bwt"])
    sm.cli("build-rindex", ["build-rindex", "g.rl_bwt", "-o", "g.ri"])
    sm.cli("build-tags", ["build-tags", "g.gbz", "g.rl_bwt", "g_full.tags"])
    sm.cli("convert-tags", ["convert-tags", "g_full.tags", "g.tags",
                            "--compact", "--no-compat"])
    s = MIN_LEN - 1
    sm.cli("build-sdict device", ["build-sdict", "g.ri", "--engine", "device",
                                  "--min-len", str(MIN_LEN)], device=True)
    if host_sdict:
        sm.cli("build-sdict host", ["build-sdict", "g.ri", "--engine", "host",
                                    "--min-len", str(MIN_LEN),
                                    "-o", "host.sdict.npz"])
        same_arrays("build-sdict device vs host", sm.path(f"g.ri.sdict{s}.npz"),
                    sm.path("host.sdict.npz"))


def phase_serve(sm: Smoke) -> None:
    """(e) find-mems and query-tags, device against native / host."""
    mems = ["find-mems", "g.ri", "g.tags", "reads.txt", str(MIN_LEN),
            str(MIN_OCC)]
    sm.cli("find-mems native", [*mems, "--engine", "native"], "mems_native.out")
    sm.cli("find-mems device", [*mems, "--engine", "device"], "mems_device.out",
           device=True)
    same_bytes("find-mems device vs native",
               strip_timing(read_bytes(sm.path("mems_device.out"))),
               strip_timing(read_bytes(sm.path("mems_native.out"))))
    q = ["query-tags", "g.ri", "g.tags", "exact.txt"]
    sm.cli("query-tags host", [*q, "--engine", "host"], "qt_host.out")
    sm.cli("query-tags device", [*q, "--engine", "device"], "qt_device.out",
           device=True)
    same_bytes("query-tags device vs host", read_bytes(sm.path("qt_device.out")),
               read_bytes(sm.path("qt_host.out")))


def _write_lines(path: str, lines: list[bytes]) -> None:
    with open(path, "wb") as fh:
        fh.write(b"\n".join(lines) + b"\n")


def phase_merge_inputs(sm: Smoke, sz: Sizes, seed: int = 11) -> None:
    """Per-component tag files, the whole-genome graph and r-index: the
    inputs of merge-tags."""
    from pangenome_index_tpu.formats.gbz_write import save_gbz
    from pangenome_index_tpu.utils.synth import synth_multi_component_gbz

    whole, subs, _ = synth_multi_component_gbz(
        sz.merge_base_len, sz.merge_haps, n_comps=sz.merge_comps,
        site_rate=0.002, seed=seed)
    os.makedirs(sm.path("comp_tags"), exist_ok=True)
    save_gbz(whole, sm.path("whole.gbz"))
    for c, sub in enumerate(subs):
        save_gbz(sub, sm.path(f"comp{c}.gbz"))
        sm.cli(f"comp{c} extract-text",
               ["extract-text", f"comp{c}.gbz", "-o", f"comp{c}.txt"])
        sm.cli(f"comp{c} build-bwt",
               ["build-bwt", f"comp{c}.txt", f"comp{c}.rl_bwt"])
        sm.cli(f"comp{c} build-tags",
               ["build-tags", f"comp{c}.gbz", f"comp{c}.rl_bwt",
                f"comp_tags/comp{c}.tags"])
    sm.cli("whole extract-text", ["extract-text", "whole.gbz", "-o", "whole.txt"])
    sm.cli("whole build-bwt", ["build-bwt", "whole.txt", "whole.rl_bwt"])
    sm.cli("whole build-rindex", ["build-rindex", "whole.rl_bwt", "-o", "whole.ri"])
    sm.cli("merge-tags host", ["merge-tags", "whole.gbz", "whole.ri",
                               "comp_tags", "merged_host.tags"])


def phase_merge_device(sm: Smoke, label: str = "merge-tags device") -> None:
    sm.cli(label, ["merge-tags", "whole.gbz", "whole.ri", "comp_tags",
                   "merged_device.tags", "--engine", "device"], device=True)
    same_bytes(f"{label} vs host", read_bytes(sm.path("merged_device.tags")),
               read_bytes(sm.path("merged_host.tags")))


def phase_other(sm: Smoke, sz: Sizes, seed: int = 13) -> None:
    """(f) build-bwt --engine device on a few Mbp, merge-tags --engine
    device on a multi-component graph, print-stats --runtime."""
    from pangenome_index_tpu.utils.synth import synth_graph_gbz

    _, lines = synth_graph_gbz(sz.bwt_base_len, sz.n_haps, seed=seed)
    _write_lines(sm.path("small.txt"), lines)
    sm.cli("build-bwt native (small)", ["build-bwt", "small.txt", "small_n.rl_bwt"])
    sm.cli("build-bwt device (small)", ["build-bwt", "small.txt", "small_d.rl_bwt",
                                        "--engine", "device"], device=True)
    same_bytes("build-bwt device vs native", read_bytes(sm.path("small_d.rl_bwt")),
               read_bytes(sm.path("small_n.rl_bwt")))
    phase_merge_inputs(sm, sz)
    phase_merge_device(sm)
    sm.cli("print-stats", ["print-stats", "g.ri", "g.tags", "--runtime"],
           "stats.out")
    stats = read_bytes(sm.path("stats.out")).decode()
    want = os.path.getsize(sm.path("g.ri"))
    if f"TOTAL r-index (on disk): {want} bytes" not in stats:
        raise PhaseError("print-stats: r-index total differs from the file size")
    say(f"print-stats --runtime: r-index total equals the file ({want} bytes)")


def phase_measure(sm: Smoke, card: str) -> dict:
    """(g) Device reads/s (MEMs only and both halves), compile time, peak
    device bytes and the LF-step rate, cross-checked against native."""
    rec = sm.run("measure", [str(REPO / "chip_smoke.py"), "--measure",
                             "measure.json"], report="measure.json")
    say(f"on {card}: find-mems device {rec['mem_rps']:.1f} reads/s MEMs only, "
        f"{rec['tags_rps']:.1f} reads/s both halves (m={rec['mer_m']}, "
        f"s={rec['sdict_s']}, min_len {MIN_LEN}, min_occ {MIN_OCC}, "
        f"{rec['n_reads']} reads); native 1 thread {rec['native_rps']:.1f} "
        f"reads/s")
    say(f"on {card}: LF steps of the plain checkpoint gather "
        f"{rec['ext_rate']:.4g}/s; serving compile {rec['compile_s']:.1f} s; "
        f"peak_bytes_in_use {rec['peak_bytes']}")
    return rec


def check_placement(mesh: str, err: str) -> None:
    """The mesh path's own report of where the index rows live: with M
    model shards every device holds 1/M of them (M=1: a full copy each), so
    no device holds the table alone."""
    n_data, n_model = (int(v) for v in mesh.split("x"))
    m = re.search(rf"mesh {mesh}: index rows (\d+), per device \[([\d, ]*)\]",
                  err)
    if not m:
        raise PhaseError(f"--mesh {mesh}: no placement report")
    total = int(m.group(1))
    per = [int(v) for v in m.group(2).split(",")]
    if len(per) != n_data * n_model or per != [total // n_model] * len(per):
        raise PhaseError(f"--mesh {mesh}: index rows per device {per}, want "
                         f"{total // n_model} on each of {n_data * n_model}")
    say(f"--mesh {mesh}: {per[0]} of {total} index rows on each device")


def phase_four_cards(sm: Smoke) -> None:
    """Sharded serving over 1x4 and 4x1 meshes against the native output,
    and the four-card device merge against the host merge."""
    mems = ["find-mems", "g.ri", "g.tags", "reads.txt", str(MIN_LEN),
            str(MIN_OCC)]
    sm.cli("find-mems native", [*mems, "--engine", "native"], "mems_native.out")
    want = strip_timing(read_bytes(sm.path("mems_native.out")))
    for mesh in ("1x4", "4x1"):
        rec = sm.cli(f"find-mems mesh {mesh}", [*mems, "--mesh", mesh],
                     f"mems_{mesh}.out", device=True)
        same_bytes(f"find-mems --mesh {mesh} vs native",
                   strip_timing(read_bytes(sm.path(f"mems_{mesh}.out"))), want)
        check_placement(mesh, sm.err(f"find-mems mesh {mesh}"))
        # every card must have held its share (the CPU backend keeps no
        # allocator statistics: nothing to check there)
        peaks = [b for b in rec["peak_bytes"] if b is not None]
        if peaks and (len(peaks) < 4 or min(peaks) == 0):
            raise PhaseError(f"--mesh {mesh}: not every device held arrays "
                             f"(peak bytes {rec['peak_bytes']})")
    phase_merge_device(sm, "merge-tags device (4 cards)")


# ---------------------------------------------------------------- children


def child_probe(report: str) -> int:
    from pangenome_index_tpu.device import device_record

    with open(report, "w") as fh:
        json.dump(device_record(), fh)
    return 0


def _compile_clock():
    """Sums XLA backend-compile seconds (persistent-cache hits count only
    their retrieval)."""
    import jax

    total = [0.0]

    def listener(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    return total


def _peak_bytes():
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.local_devices()]


def child_cli(report: str, argv: list[str]) -> int:
    """A device `panidx` command with its compile seconds and per-device
    peak bytes written to `report`."""
    from pangenome_index_tpu import cli

    clock = _compile_clock()
    rc = cli.main(argv)
    sys.stdout.flush()
    with open(report, "w") as fh:
        json.dump({"compile_s": clock[0], "peak_bytes": _peak_bytes()}, fh)
    return rc


def child_measure(report: str) -> int:
    """The serving measurement of bench.py on the smoke index."""
    sys.path.insert(0, str(REPO))
    import bench
    from pangenome_index_tpu.cli import _pack_reads, _read_reads, \
        _resolve_long_seed, _resolve_mer_len
    from pangenome_index_tpu.device import setup_compile_cache
    from pangenome_index_tpu.formats import ri, tags as tagfmt

    setup_compile_cache()
    clock = _compile_clock()
    idx = ri.load_file("g.ri")
    tags = tagfmt.load_tags_file("g.tags")
    codes, lens = _pack_reads(_read_reads("reads.txt"))
    mer_m = _resolve_mer_len(-1, MIN_LEN, idx.n)
    s = _resolve_long_seed(-1, MIN_LEN, mer_m, idx)
    m = bench.serve_measure(idx, codes, lens, MIN_LEN, MIN_OCC, mer_m=mer_m,
                            sdict_s=s, sdict_path=f"g.ri.sdict{s}.npz",
                            tag_tables=tags, measure_ext=True)
    native_rps, _ = bench.native_baseline(
        idx, codes, lens, m["counts"], min_len=MIN_LEN, min_occ=MIN_OCC,
        tags=tags, tag_dev=(m["tag_nu"], m["tag_ov"]))
    with open(report, "w") as fh:
        json.dump({"mem_rps": m["device_rps"], "tags_rps": m["tags_rps"],
                   "native_rps": native_rps, "ext_rate": m["ext_rate"],
                   "mer_m": mer_m, "sdict_s": s, "n_reads": len(codes),
                   "chunk": m["chunk"], "tag_overflow": m["tag_ov_frac"],
                   "serve_compile_s": m["compile_s"],
                   "compile_s": clock[0], "peak_bytes": _peak_bytes()}, fh)
    return 0


# ---------------------------------------------------------------- main


def run_smoke(four_cards: bool, work: pathlib.Path = WORK) -> dict:
    if not (REPO / "pangenome_index_tpu" / "cli.py").exists():
        raise PhaseError(f"{REPO} holds no pangenome_index_tpu package")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sm = Smoke(work)
    t0 = time.perf_counter()
    info = phase_identify(sm, 4 if four_cards else 1)
    phase_native(sm)
    if four_cards:
        phase_dataset(sm, FOUR)
        phase_index(sm, host_sdict=False)
        phase_merge_inputs(sm, FOUR)
        phase_four_cards(sm)
    else:
        phase_dataset(sm, FULL)
        phase_index(sm)
        phase_serve(sm)
        phase_other(sm, FULL)
        phase_measure(sm, info["card"])
    compile_s = sum(s.get("compile_s", 0.0) for s in sm.steps)
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s; XLA compile "
        f"{compile_s:.1f} s in all; on {info['card']}")
    with open(work / "steps.json", "w") as fh:
        json.dump(sm.steps, fh, indent=1)
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card paths (needs 4 GPUs)")
    p.add_argument("--probe", metavar="REPORT", help=argparse.SUPPRESS)
    p.add_argument("--measure", metavar="REPORT", help=argparse.SUPPRESS)
    p.add_argument("--child", metavar="REPORT", help=argparse.SUPPRESS)
    p.add_argument("cli_args", nargs="*", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.probe:
        return child_probe(args.probe)
    if args.measure:
        return child_measure(args.measure)
    if args.child:
        return child_cli(args.child, args.cli_args)
    sys.path.insert(0, str(REPO))
    try:
        info = run_smoke(args.four_cards)
    except (PhaseError, OSError, ImportError) as exc:
        print(f"[smoke] FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
