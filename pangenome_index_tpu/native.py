"""ctypes bindings for the native CPU serving engine (src/cpp).

The library is compiled from the committed sources into build/ on first use
(g++ -O3 -march=native -fopenmp, the flags and source list of
src/cpp/CMakeLists.txt), or ahead of time with

    python -m pangenome_index_tpu.native

The native engine is the CPU baseline of the benchmark, the cross-check of
every device engine, and the host-side runtime - the counterpart of the
reference's C++ find_mems/query_tags binaries.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import re
import subprocess
import sys

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "cpp"
BUILD_DIR = _SRC.parent.parent / "build"
LIB_PATH = BUILD_DIR / "libpanindex_native.so"
_lib = None
#: why the last build failed (compiler stderr), for error messages
build_error: str | None = None


def sources() -> list[pathlib.Path]:
    """The library's sources, as listed in src/cpp/CMakeLists.txt."""
    text = (_SRC / "CMakeLists.txt").read_text()
    m = re.search(r"add_library\(\s*panindex_native\s+SHARED\s+([^)]*)\)", text)
    return [_SRC / name for name in m.group(1).split()]


def build() -> bool:
    """Compile the library into build/ unless it is newer than every source.
    One process compiles while concurrent ones wait on a lock file."""
    global build_error
    if not (_SRC / "CMakeLists.txt").exists():
        build_error = f"{_SRC} holds no sources"
        return False
    srcs = sources()

    def fresh():
        return LIB_PATH.exists() and all(
            LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in srcs)

    if fresh():
        return True
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return True
        # compile to a private temp and rename: no process may dlopen a
        # half-written library
        tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
        try:
            subprocess.run(
                ["g++", "-std=c++17", "-O3", "-march=native", "-fopenmp",
                 "-shared", "-fPIC", *[str(s) for s in srcs], "-o", str(tmp)],
                check=True, capture_output=True, timeout=300,
            )
        except (OSError, subprocess.SubprocessError) as exc:
            tmp.unlink(missing_ok=True)
            build_error = (exc.stderr.decode(errors="replace")
                           if getattr(exc, "stderr", None) else str(exc))
            return False
        os.replace(tmp, LIB_PATH)
        return True


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.panindex_version.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def find_mems_native(idx, codes: np.ndarray, lengths: np.ndarray,
                     min_len: int, min_occ: int, capacity: int = 64,
                     n_threads: int = 0):
    """Batched MEM finding on the native engine. Returns
    (start, end, bwt, size, count) arrays like ops.mems.MemResult."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    B, L = codes.shape
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    run_sym = np.ascontiguousarray(idx.run_sym, np.int8)
    run_start = np.ascontiguousarray(idx.run_start, np.int64)
    cum = np.ascontiguousarray(idx.cum, np.int64)
    C = np.ascontiguousarray(idx.C, np.int64)
    out = [np.zeros((B, capacity), np.int64) for _ in range(4)]
    count = np.zeros(B, np.int32)
    lib.panindex_find_mems(
        _ptr(run_sym, ctypes.c_int8), _ptr(run_start, ctypes.c_int64),
        _ptr(cum, ctypes.c_int64), _ptr(C, ctypes.c_int64),
        ctypes.c_int64(idx.n_runs), ctypes.c_int64(idx.n),
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L),
        ctypes.c_int64(min_len), ctypes.c_int64(min_occ), ctypes.c_int64(capacity),
        _ptr(out[0], ctypes.c_int64), _ptr(out[1], ctypes.c_int64),
        _ptr(out[2], ctypes.c_int64), _ptr(out[3], ctypes.c_int64),
        _ptr(count, ctypes.c_int32), ctypes.c_int32(n_threads),
    )
    return out[0], out[1], out[2], out[3], count


def query_tags_native(tags, starts: np.ndarray, ends: np.ndarray,
                      capacity: int = 256, exact: bool = False,
                      n_threads: int = 0):
    """Batched tag interval queries; returns (positions [B, capacity],
    n_unique [B], n_runs [B]) matching models.tagarray.TagArray.query."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    pos_enc = np.ascontiguousarray(tags.pos_enc, np.int64)
    bwt_start = np.ascontiguousarray(tags.bwt_start, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    B = len(starts)
    out_pos = np.zeros((B, capacity), np.int64)
    out_unique = np.zeros(B, np.int32)
    out_runs = np.zeros(B, np.int32)
    lib.panindex_query_tags(
        _ptr(pos_enc, ctypes.c_int64), _ptr(bwt_start, ctypes.c_int64),
        ctypes.c_int64(tags.n_runs),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        ctypes.c_int64(B), ctypes.c_int64(capacity), ctypes.c_int(1 if exact else 0),
        _ptr(out_pos, ctypes.c_int64), _ptr(out_unique, ctypes.c_int32),
        _ptr(out_runs, ctypes.c_int32), ctypes.c_int32(n_threads),
    )
    return out_pos, out_unique, out_runs


def build_bwt_native(lines: list[bytes], force64: bool = False):
    """Multi-string BWT via SA-IS (linear time) - the production-scale native
    replacement for the rotation-sort oracle. Returns (bwt bytes array, da,
    sa_pos, seq_lengths) with the oracle's exact contract.

    The index width is chosen by input size (int32 below 2^31 characters,
    int64 above - no per-shard capacity cliff); force64 pins the int64
    instantiation for tests."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    text = np.frombuffer(b"".join(lines), np.uint8)
    seq_lens = np.array([len(l) for l in lines], np.int64)
    seq_ends = np.cumsum(seq_lens)
    n = int(text.size + len(lines))
    bwt = np.zeros(n, np.uint8)
    if not force64 and n + 1 < 2**31:
        # int32 da/sa_pos below 2^31 rows: these arrays ride through the
        # r-index (_sa_hint keeps dtype) and the tag gather, so 8 B/char of
        # the build-plane working set becomes 4
        da = np.zeros(n, np.int32)
        sa_pos = np.zeros(n, np.int32)
        lib.panindex_build_bwt_i32(
            _ptr(np.ascontiguousarray(text), ctypes.c_uint8), ctypes.c_int64(text.size),
            _ptr(np.ascontiguousarray(seq_ends), ctypes.c_int64), ctypes.c_int64(len(lines)),
            _ptr(bwt, ctypes.c_uint8), _ptr(da, ctypes.c_int32), _ptr(sa_pos, ctypes.c_int32),
        )
        return bwt, da, sa_pos, seq_lens + 1
    da = np.zeros(n, np.int64)
    sa_pos = np.zeros(n, np.int64)
    fn = lib.panindex_build_bwt_force64 if force64 else lib.panindex_build_bwt
    fn(
        _ptr(np.ascontiguousarray(text), ctypes.c_uint8), ctypes.c_int64(text.size),
        _ptr(np.ascontiguousarray(seq_ends), ctypes.c_int64), ctypes.c_int64(len(lines)),
        _ptr(bwt, ctypes.c_uint8), _ptr(da, ctypes.c_int64), _ptr(sa_pos, ctypes.c_int64),
    )
    return bwt, da, sa_pos, seq_lens + 1


def count_native(idx, codes: np.ndarray, lengths: np.ndarray, n_threads: int = 0):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    B, L = codes.shape
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    run_sym = np.ascontiguousarray(idx.run_sym, np.int8)
    run_start = np.ascontiguousarray(idx.run_start, np.int64)
    cum = np.ascontiguousarray(idx.cum, np.int64)
    C = np.ascontiguousarray(idx.C, np.int64)
    first = np.zeros(B, np.int64)
    second = np.zeros(B, np.int64)
    lib.panindex_count(
        _ptr(run_sym, ctypes.c_int8), _ptr(run_start, ctypes.c_int64),
        _ptr(cum, ctypes.c_int64), _ptr(C, ctypes.c_int64),
        ctypes.c_int64(idx.n_runs), ctypes.c_int64(idx.n),
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L),
        _ptr(first, ctypes.c_int64), _ptr(second, ctypes.c_int64),
        ctypes.c_int32(n_threads),
    )
    return first, second


def format_mems_native(counts: np.ndarray, starts: np.ndarray,
                       ends: np.ndarray, bwts: np.ndarray, sizes: np.ndarray,
                       tuniq: np.ndarray | None, tpos: np.ndarray | None,
                       fd: int) -> int:
    """Render the find-mems stdout format (src/cpp/mem_format.cpp) straight
    to `fd` from flat per-MEM arrays: counts [n_reads], starts/ends/bwts/
    sizes [n_flat], tag positions tpos [n_flat, tstride] with tuniq valid
    entries per row (None = no tag sections). Returns bytes written.

    Raises RuntimeError when the engine (or, via hasattr, a stale .so
    without this entry point) is unavailable - callers keep the Python
    emission loop as the fallback."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "panindex_format_mems"):
        raise RuntimeError("native formatter unavailable")
    counts = np.ascontiguousarray(counts, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    bwts = np.ascontiguousarray(bwts, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    if tuniq is None:
        tq = tp = None
        tstride = 0
    else:
        tq = np.ascontiguousarray(tuniq, np.int64)
        tp = np.ascontiguousarray(tpos, np.int64)
        tstride = tp.shape[1] if tp.ndim == 2 else 0
    lib.panindex_format_mems.restype = ctypes.c_int64
    n = lib.panindex_format_mems(
        ctypes.c_int64(len(counts)), _ptr(counts, ctypes.c_int64),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(bwts, ctypes.c_int64), _ptr(sizes, ctypes.c_int64),
        None if tq is None else _ptr(tq, ctypes.c_int64),
        None if tp is None else _ptr(tp, ctypes.c_int64),
        ctypes.c_int64(tstride), ctypes.c_int(fd),
    )
    if n < 0:
        raise RuntimeError("native formatter write failed")
    return int(n)


def window_radix_native(dict_keys: np.ndarray, s: int, bits: int = 20):
    """Bucket-start table over the dictionary keys' high bits (one-time per
    loaded dictionary; src/cpp/read_windows.cpp). Returns (lo [2^bits + 1]
    int64, shift) for read_windows_native."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "panindex_window_radix"):
        raise RuntimeError("native window engine unavailable")
    dict_keys = np.ascontiguousarray(dict_keys, np.int64)
    shift = max(0, 2 * int(s) - bits)
    lo = np.zeros((1 << bits) + 1, np.int64)
    lib.panindex_window_radix(
        _ptr(dict_keys, ctypes.c_int64), ctypes.c_int64(len(dict_keys)),
        ctypes.c_int64(shift), ctypes.c_int64(1 << bits),
        _ptr(lo, ctypes.c_int64))
    return lo, shift


def read_windows_native(codes: np.ndarray, lengths: np.ndarray, m: int,
                        dict_keys: np.ndarray | None = None,
                        radix=None, n_threads: int = 0):
    """read_mer_keys (+ lookup_read_windows when dict_keys is given) in one
    OpenMP pass (src/cpp/read_windows.cpp): (keys [B, L+1], valid [B, L+1],
    idx [B, L+1] or None). Bit-identical to the numpy forms (fuzz-tested);
    `radix` is (lo, shift) from window_radix_native (built here if omitted)."""
    from .ops.mertable import CODE_TO_BASE

    lib = get_lib()
    if lib is None or not hasattr(lib, "panindex_read_windows"):
        raise RuntimeError("native window engine unavailable")
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, L = codes.shape
    c2b = np.ascontiguousarray(CODE_TO_BASE, np.int8)
    keys = np.zeros((B, L + 1), np.int64)
    valid = np.zeros((B, L + 1), np.uint8)
    idx = None
    dk_ptr = rl_ptr = None
    n_keys = shift = 0
    if dict_keys is not None and len(dict_keys):
        dict_keys = np.ascontiguousarray(dict_keys, np.int64)
        if radix is None:
            radix = window_radix_native(dict_keys, m)
        rlo, shift = radix
        rlo = np.ascontiguousarray(rlo, np.int64)
        dk_ptr = _ptr(dict_keys, ctypes.c_int64)
        rl_ptr = _ptr(rlo, ctypes.c_int64)
        n_keys = len(dict_keys)
        idx = np.full((B, L + 1), -1, np.int32)
    lib.panindex_read_windows(
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L), ctypes.c_int64(m),
        _ptr(c2b, ctypes.c_int8), ctypes.c_int64(len(c2b)),
        dk_ptr, ctypes.c_int64(n_keys), rl_ptr, ctypes.c_int64(shift),
        _ptr(keys, ctypes.c_int64), _ptr(valid, ctypes.c_uint8),
        None if idx is None else _ptr(idx, ctypes.c_int32),
        ctypes.c_int32(n_threads))
    return (keys.astype(np.int32 if m <= 15 else np.int64),
            valid.astype(bool), idx)


def psi_walk_native(run_start: np.ndarray, psi_base: np.ndarray,
                    is_end: np.ndarray, n: int, n_seq: int,
                    n_threads: int = 0, full_sa: bool = False,
                    window: tuple[int, int] | None = None):
    """Run-length-bounded psi walk (src/cpp/psi_walk.cpp): the O(r)-memory
    replacement for the numpy full-permutation walk in build_rindex. Returns
    (head_seq, head_t, tail_seq, tail_t, seq_len) - lane + step at every run
    head/tail plus per-sequence lengths (incl. endmarker). With full_sa=True,
    two extra arrays (sa_seq, sa_t) give the per-row lane + step; `window`
    = (lo, hi) restricts them to rows [lo, hi) (stored at i - lo) so the
    streamed tag build keeps O(r + window) memory per pass instead of the
    full 16 B/row product. n_threads partitions lanes over OpenMP threads
    (lanes partition the rows - no synchronization; 0 = OpenMP default)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not hasattr(lib, "panindex_psi_walk_v2"):
        # the window args were appended to the original signature; an old
        # .so would silently ignore them and write a full-[n] SA into the
        # (hi-lo)-sized buffers below (advisor r4) - fail loudly instead
        raise RuntimeError(
            "stale libpanindex_native.so: panindex_psi_walk_v2 missing "
            "(delete the .so to trigger a rebuild)")
    run_start = np.ascontiguousarray(run_start, np.int64)
    psi_base = np.ascontiguousarray(psi_base, np.int64)
    is_end = np.ascontiguousarray(is_end, np.uint8)
    r = run_start.size
    head_seq = np.zeros(r, np.int64)
    head_t = np.zeros(r, np.int64)
    tail_seq = np.zeros(r, np.int64)
    tail_t = np.zeros(r, np.int64)
    seq_len = np.zeros(n_seq, np.int64)
    if full_sa:
        lo, hi = window if window is not None else (0, n)
        sa_seq = np.zeros(hi - lo, np.int64)
        sa_t = np.zeros(hi - lo, np.int64)
        sa_args = (_ptr(sa_seq, ctypes.c_int64), _ptr(sa_t, ctypes.c_int64))
    else:
        lo, hi = 0, 0
        sa_args = (None, None)
    lib.panindex_psi_walk_v2(
        _ptr(run_start, ctypes.c_int64), _ptr(psi_base, ctypes.c_int64),
        _ptr(is_end, ctypes.c_uint8),
        ctypes.c_int64(r), ctypes.c_int64(n), ctypes.c_int64(n_seq),
        _ptr(head_seq, ctypes.c_int64), _ptr(head_t, ctypes.c_int64),
        _ptr(tail_seq, ctypes.c_int64), _ptr(tail_t, ctypes.c_int64),
        _ptr(seq_len, ctypes.c_int64), ctypes.c_int32(n_threads),
        *sa_args, ctypes.c_int64(lo), ctypes.c_int64(hi),
    )
    out = (head_seq, head_t, tail_seq, tail_t, seq_len)
    return out + (sa_seq, sa_t) if full_sa else out


def unpack_bits_native(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Single-pass LSB-first bit-field unpack (src/cpp/bitio.cpp)."""
    lib = get_lib()
    words = np.ascontiguousarray(words, "<u8")
    out = np.zeros(count, np.int64)
    lib.panindex_unpack_bits(
        _ptr(words, ctypes.c_uint64), ctypes.c_int64(words.size),
        ctypes.c_int64(width), ctypes.c_int64(count), _ptr(out, ctypes.c_int64))
    return out


def pack_bits_native(values: np.ndarray, width: int) -> np.ndarray:
    """Inverse of unpack_bits_native; returns LE uint64 words."""
    lib = get_lib()
    values = np.ascontiguousarray(values, np.int64)
    nwords = (values.size * width + 63) // 64
    words = np.zeros(nwords, "<u8")
    lib.panindex_pack_bits(
        _ptr(values, ctypes.c_int64), ctypes.c_int64(values.size),
        ctypes.c_int64(width), _ptr(words, ctypes.c_uint64))
    return words


def set_bits_native(words: np.ndarray, nbits: int, expected: int) -> np.ndarray:
    """Indices of set bits (ctz scan) - the sd_vector high-bits decode."""
    lib = get_lib()
    lib.panindex_set_bits.restype = ctypes.c_int64
    words = np.ascontiguousarray(words, "<u8")
    out = np.zeros(expected, np.int64)
    got = lib.panindex_set_bits(
        _ptr(words, ctypes.c_uint64), ctypes.c_int64(nbits),
        _ptr(out, ctypes.c_int64), ctypes.c_int64(expected))
    return out[:got]


if __name__ == "__main__":
    if not build():
        sys.exit(f"native build failed:\n{build_error}")
    print(LIB_PATH)
