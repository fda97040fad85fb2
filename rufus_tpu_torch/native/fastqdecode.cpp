// Native FASTQ batch decoder (plain or gzip via zlib) — the host-side
// throughput path for fastq input modalities: a chunked memchr scanner,
// consumed through ctypes like bamdecode.cpp.
//
// Reference role: the generator -> PassThroughSamCheck stream adapters
// (runRufus.sh:595-658, PassThroughSamCheck.cpp:30-158) for the
// fastq-direct inputs (runRufus.sh:971-983).
//
// API (extern "C", consumed by rufus_tpu_torch/io/native.py):
//   fastq_open(path) -> handle
//   fastq_read_batch(h, max_reads, pad, seq, len) -> n   (seq: n x pad,
//       'N'-padded; len: per-read true length, clamped to pad)
//   fastq_close(h)
//   fastq_pair_open(path1, path2) -> handle
//   fastq_pair_read_batch(h, max_reads, pad, s1, q1, l1, s2, q2, l2,
//       names, names_cap, name_off) -> n   (names: '\0'-joined R1 names
//       without '@', cut at first space; name_off: n+1 offsets)
//   fastq_pair_close(h)

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FastqFile {
  gzFile f = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;

  explicit FastqFile(const char* path) : buf(8u << 20) {
    f = gzopen(path, "rb");
    if (f) gzbuffer(f, 1u << 20);
  }
  ~FastqFile() {
    if (f) gzclose(f);
  }
  bool ok() const { return f != nullptr; }

  void fill() {
    if (eof) return;
    if (pos > 0) {
      memmove(buf.data(), buf.data() + pos, len - pos);
      len -= pos;
      pos = 0;
    }
    if (len == buf.size()) buf.resize(buf.size() * 2);  // giant line
    int got = gzread(f, buf.data() + len, (unsigned)(buf.size() - len));
    if (got <= 0) {
      eof = true;
      return;
    }
    len += (size_t)got;
  }

  // next line (without terminator); returns false at clean EOF
  bool next_line(const char** p, size_t* n) {
    for (;;) {
      char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        *p = buf.data() + pos;
        *n = (size_t)(nl - (buf.data() + pos));
        if (*n && (*p)[*n - 1] == '\r') --*n;
        pos = (size_t)(nl - buf.data()) + 1;
        return true;
      }
      if (eof) {
        if (pos < len) {  // last line without newline
          *p = buf.data() + pos;
          *n = len - pos;
          pos = len;
          return true;
        }
        return false;
      }
      fill();
    }
  }

  // Make sure the next 4 lines (or everything to EOF) are contiguous in
  // the buffer BEFORE handing out pointers: next_line's fill() memmoves
  // the buffer, which would dangle earlier lines of the same record.
  void ensure_record_buffered() {
    for (;;) {
      int nl = 0;
      const char* base = buf.data() + pos;
      size_t left = len - pos;
      const char* q = base;
      while (nl < 4) {
        const char* hit = (const char*)memchr(q, '\n', left - (size_t)(q - base));
        if (!hit) break;
        ++nl;
        q = hit + 1;
        if ((size_t)(q - base) >= left) break;
      }
      if (nl >= 4 || eof) return;
      fill();
    }
  }

  // one 4-line record; pointers stay valid until the NEXT next_record
  // call. Returns 0 EOF, 1 ok, -1 malformed.
  int next_record(const char** name, size_t* name_n, const char** seq,
                  size_t* seq_n, const char** qual, size_t* qual_n) {
    ensure_record_buffered();
    const char* l;
    size_t n;
    do {
      if (!next_line(&l, &n)) return 0;
    } while (n == 0);
    if (l[0] != '@') return -1;
    *name = l + 1;
    *name_n = n - 1;
    if (!next_line(seq, seq_n)) return -1;
    if (!next_line(&l, &n) || n == 0 || l[0] != '+') return -1;
    if (!next_line(qual, qual_n)) return -1;
    return 1;
  }
};

struct FastqPair {
  FastqFile a, b;
  // one-record pushback: an R1 record whose name overflowed the caller's
  // names buffer is parked here instead of being lost — by the time the
  // overflow is detected the record has already been consumed from the
  // gzip stream, and a naive "grow and retry" would silently drop it and
  // every earlier pair of the batch, desyncing R1/R2 forever.
  std::string pend_name, pend_seq, pend_qual;
  bool has_pend = false;
  FastqPair(const char* p1, const char* p2) : a(p1), b(p2) {}
};

// copy up to pad bases; pad-fill with 'N'
inline void put_row(uint8_t* dst, long pad, const char* src, size_t n) {
  size_t m = n < (size_t)pad ? n : (size_t)pad;
  memcpy(dst, src, m);
  if ((long)m < pad) memset(dst + m, 'N', (size_t)(pad - m));
}

}  // namespace

extern "C" {

void* fastq_open(const char* path) {
  auto* f = new FastqFile(path);
  if (!f->ok()) {
    delete f;
    return nullptr;
  }
  return f;
}

long fastq_read_batch(void* h, long max_reads, long pad, uint8_t* seq,
                      int32_t* lens) {
  auto* f = (FastqFile*)h;
  long n = 0;
  const char *nm, *sq, *ql;
  size_t nm_n, sq_n, ql_n;
  while (n < max_reads) {
    int r = f->next_record(&nm, &nm_n, &sq, &sq_n, &ql, &ql_n);
    if (r == 0) break;
    if (r < 0) return -1;
    put_row(seq + n * pad, pad, sq, sq_n);
    lens[n] = (int32_t)(sq_n < (size_t)pad ? sq_n : (size_t)pad);
    ++n;
  }
  return n;
}

void fastq_close(void* h) { delete (FastqFile*)h; }

void* fastq_pair_open(const char* p1, const char* p2) {
  auto* p = new FastqPair(p1, p2);
  if (!p->a.ok() || !p->b.ok()) {
    delete p;
    return nullptr;
  }
  return p;
}

long fastq_pair_read_batch(void* h, long max_reads, long pad, uint8_t* s1,
                           uint8_t* q1, int32_t* l1, uint8_t* s2, uint8_t* q2,
                           int32_t* l2, uint8_t* names, long names_cap,
                           int32_t* name_off) {
  auto* p = (FastqPair*)h;
  long n = 0;
  long noff = 0;
  const char *nm, *sq, *ql;
  size_t nm_n, sq_n, ql_n;
  std::string hn, hs, hq;  // keeps a resumed pushback record alive
  name_off[0] = 0;
  while (n < max_reads) {
    if (p->has_pend) {
      hn.swap(p->pend_name);
      hs.swap(p->pend_seq);
      hq.swap(p->pend_qual);
      p->has_pend = false;
      nm = hn.data();
      nm_n = hn.size();
      sq = hs.data();
      sq_n = hs.size();
      ql = hq.data();
      ql_n = hq.size();
    } else {
      int r = p->a.next_record(&nm, &nm_n, &sq, &sq_n, &ql, &ql_n);
      if (r == 0) break;
      if (r < 0) return -1;
    }
    // R1 name, cut at first space
    const char* sp = (const char*)memchr(nm, ' ', nm_n);
    size_t cut = sp ? (size_t)(sp - nm) : nm_n;
    if (noff + (long)cut + 1 > names_cap) {
      // lossless overflow: park the already-consumed R1 record and hand
      // back the pairs decoded so far (a short batch, NOT end-of-stream);
      // only when even the first record doesn't fit does the caller need
      // to grow the buffer and retry (-2) — the record survives in the
      // handle either way.
      p->pend_name.assign(nm, nm_n);
      p->pend_seq.assign(sq, sq_n);
      p->pend_qual.assign(ql, ql_n);
      p->has_pend = true;
      return n > 0 ? n : -2;
    }
    memcpy(names + noff, nm, cut);
    noff += (long)cut;
    names[noff++] = 0;
    put_row(s1 + n * pad, pad, sq, sq_n);
    l1[n] = (int32_t)(sq_n < (size_t)pad ? sq_n : (size_t)pad);
    put_row(q1 + n * pad, pad, ql, ql_n);

    int r2 = p->b.next_record(&nm, &nm_n, &sq, &sq_n, &ql, &ql_n);
    if (r2 <= 0) return -1;  // R2 shorter than R1
    put_row(s2 + n * pad, pad, sq, sq_n);
    l2[n] = (int32_t)(sq_n < (size_t)pad ? sq_n : (size_t)pad);
    put_row(q2 + n * pad, pad, ql, ql_n);
    ++n;
    name_off[n] = (int32_t)noff;
  }
  return n;
}

void fastq_pair_close(void* h) { delete (FastqPair*)h; }

}  // extern "C"
