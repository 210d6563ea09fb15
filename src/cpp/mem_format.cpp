// Native MEM output formatter: the find_mems emission path.
//
// The CLI's device engine computes MEMs and tag positions as flat arrays;
// turning them into the reference's stdout format (find_mems.cpp:105-139
// layout, byte-compatible with this repo's Python emission loop) costs
// ~5.5M Python print/f-string calls at dense workloads (~60 s for 1.83M
// MEMs on one core). This renders the
// same bytes with to_chars into a 4 MB buffer at memory speed.
//
// Exact line format reproduced (see cli.py cmd_find_mems):
//   Seq: <i+1>\n
//   MEM START: <s>, MEM END: <e> BWT START: <b> SIZE: <z>\n
//   Number of unique positions: <u>\n
//   <v0>, <v1>, ... \n          (trailing ", " after every value)
//   \n                           (blank line after each read)

#include <charconv>
#include <cstdint>
#include <cstring>
#include <unistd.h>

namespace {

struct OutBuf {
  int fd;
  char *buf;
  size_t len = 0, cap;
  bool ok = true;
  int64_t written = 0;

  OutBuf(int fd_, char *b, size_t c) : fd(fd_), buf(b), cap(c) {}

  void flush() {
    size_t off = 0;
    while (ok && off < len) {
      ssize_t w = ::write(fd, buf + off, len - off);
      if (w < 0) { ok = false; break; }
      off += static_cast<size_t>(w);
    }
    written += static_cast<int64_t>(off);
    len = 0;
  }
  void need(size_t n) {
    if (cap - len < n) flush();
  }
  void lit(const char *s, size_t n) {
    need(n);
    std::memcpy(buf + len, s, n);
    len += n;
  }
  void num(int64_t v) {
    need(24);
    auto r = std::to_chars(buf + len, buf + cap, v);
    len = static_cast<size_t>(r.ptr - buf);
  }
};

}  // namespace

extern "C" int64_t panindex_format_mems(
    int64_t n_reads, const int64_t *counts, const int64_t *s,
    const int64_t *e, const int64_t *b, const int64_t *z,
    const int64_t *tuniq, const int64_t *tpos, int64_t tstride, int fd) {
  static const size_t CAP = size_t(4) << 20;
  char *mem = new char[CAP];
  OutBuf o(fd, mem, CAP);
  int64_t fi = 0;
  for (int64_t i = 0; i < n_reads && o.ok; ++i) {
    o.lit("Seq: ", 5);
    o.num(i + 1);
    o.lit("\n", 1);
    for (int64_t m = 0; m < counts[i]; ++m, ++fi) {
      o.lit("MEM START: ", 11);
      o.num(s[fi]);
      o.lit(", MEM END: ", 11);
      o.num(e[fi]);
      o.lit(" BWT START: ", 12);
      o.num(b[fi]);
      o.lit(" SIZE: ", 7);
      o.num(z[fi]);
      o.lit("\n", 1);
      if (tuniq) {
        int64_t u = tuniq[fi];
        o.lit("Number of unique positions: ", 28);
        o.num(u);
        o.lit("\n", 1);
        const int64_t *vp = tpos + fi * tstride;
        for (int64_t v = 0; v < u; ++v) {
          o.num(vp[v]);
          o.lit(", ", 2);
        }
        o.lit("\n", 1);
      }
    }
    o.lit("\n", 1);
  }
  o.flush();
  int64_t out = o.ok ? o.written : -1;
  delete[] mem;
  return out;
}
