// Native BAM/BGZF decoder for the rufus_tpu_torch host I/O runtime: a
// streaming reader.
//
// Replaces the pure-Python BGZF+BAM parser (rufus_tpu_torch/io/bam.py,
// its plain version) on the hot path: BAM decode is CPU-bound and must
// keep the card fed (reference pipeline equivalent: samtools view -F 3328
// | PassThroughSamCheck, runRufus.sh:595-658). Exposed via a C ABI for
// ctypes, built with the host compiler at first use (ops/_build.py).
//
// The file is read a window of BGZF blocks at a time. Each stream keeps a
// reader thread and a pool of inflate workers (`threads`, at most one a
// core): while the caller parses window i, the reader reads the windows
// after it and the pool inflates them, a block a worker at a time, the
// oldest window first. Four windows are held at most, so the memory a
// stream needs does not grow with the file.
// A record that straddles two windows is carried over in a buffer of its
// own. Each batch call walks the records of the current window and writes
// bases (two a packed byte, through a 256-entry table), qualities and
// names straight into the caller's arrays, and pads each row once, at its
// tail; qualities only when the caller passes an array for them.
//
// The pair stream keeps each pending mate (the first record seen under a
// name) in an open-addressing table keyed by the name's hash, its name,
// flag, packed bases and qualities in one arena that is compacted and
// reused. Its semantics are io/bam.py::bam_to_paired_fastq's.
//
// A truncated file, a bad block (gzip header, inflate, size or CRC) or a
// bad record makes the batch call return -1, with the reason in
// bam_error; a stream never ends short without a word.
//
// API (see rufus_tpu_torch/io/native.py):
//   bam_open(path, threads, window, err, cap) -> handle (reads the header)
//   bam_read_batch / bam_read_se_batch / bam_read_pair_batch (one stream
//       a handle: records as stored, single-end stranded, stranded pairs)
//   bam_longest, bam_put_long (the last batch's reads cut at pad_len,
//       written whole into wider arrays)
//   bam_reset, bam_error, bam_stats (the stream's counters)
//   bam_scan, bam_scan_ids (a pass of its own: record count, longest read,
//       ref_ids)
//   bam_num_refs, bam_ref_name, bam_close

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kMaxBlock = 1 << 16;  // BGZF: BSIZE and ISIZE <= 64 KiB
// Windows a stream holds: the one the caller parses and three that the
// pool inflates ahead of it, so that no worker waits for the caller or
// for the next window's read.
constexpr int kWindows = 4;

const char SEQ_CODES[17] = "=ACMGRSVTWYHKDBN";

uint8_t comp_base(uint8_t b) {  // the stranded pass-through's complement
  switch (b) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    default: return b;
  }
}

// Two ASCII bases a packed byte: FWD in stored order; RC the byte's two
// bases complemented in reverse order (low nibble first).
struct Tables {
  uint8_t fwd[256][2], rc[256][2], code[16], comp[16];
  Tables() {
    for (int c = 0; c < 16; c++) {
      code[c] = (uint8_t)SEQ_CODES[c];
      comp[c] = comp_base(code[c]);
    }
    for (int b = 0; b < 256; b++) {
      fwd[b][0] = code[b >> 4];
      fwd[b][1] = code[b & 15];
      rc[b][0] = comp[b & 15];
      rc[b][1] = comp[b >> 4];
    }
  }
};
const Tables T;

uint8_t code_at(const uint8_t* packed, uint32_t i) {
  return (i & 1) ? (packed[i >> 1] & 15) : (packed[i >> 1] >> 4);
}

// The first n of l bases into out: as stored, or reverse-complemented.
void decode_seq(const uint8_t* packed, uint32_t l, bool rev, uint8_t* out,
                uint32_t n) {
  if (!rev) {
    for (uint32_t j = 0; j < n / 2; j++)
      memcpy(out + 2 * j, T.fwd[packed[j]], 2);
    if (n & 1) out[n - 1] = T.code[code_at(packed, n - 1)];
    return;
  }
  // out[i] = comp(base l-1-i); after a lone first base when l is odd, the
  // pairs (i, i+1) are one byte's two bases, low nibble first
  uint32_t i = 0;
  if ((l & 1) && n > 0) out[i++] = T.comp[code_at(packed, l - 1)];
  for (; i + 1 < n; i += 2) memcpy(out + i, T.rc[packed[(l - 2 - i) / 2]], 2);
  if (i < n) out[i] = T.comp[code_at(packed, l - 1 - i)];
}

void decode_qual(const uint8_t* q, uint32_t l, bool rev, uint8_t* out,
                 uint32_t n) {
  if (!rev) {
    for (uint32_t i = 0; i < n; i++)
      out[i] = q[i] == 0xFF ? '*' : (uint8_t)(q[i] + 33);
  } else {
    for (uint32_t i = 0; i < n; i++) {
      uint8_t v = q[l - 1 - i];
      out[i] = v == 0xFF ? '*' : (uint8_t)(v + 33);
    }
  }
}

uint16_t u16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
int32_t i32(const uint8_t* p) { int32_t v; memcpy(&v, p, 4); return v; }
uint32_t u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }

// A growable byte buffer that keeps its allocation (no zero fill).
struct Buf {
  std::unique_ptr<uint8_t[]> p;
  size_t cap = 0, size = 0;
  void reserve(size_t n) {  // keeps the first `size` bytes
    if (n <= cap) return;
    size_t c = std::max(n, 2 * cap);
    std::unique_ptr<uint8_t[]> q(new uint8_t[c]);
    if (size) memcpy(q.get(), p.get(), size);
    p = std::move(q);
    cap = c;
  }
  uint8_t* data() { return p.get(); }
};

struct Block { size_t in_off, in_len, out_off, out_len; };

struct Window {
  Buf comp;  // the window's BGZF blocks as read
  Buf data;  // their payloads, inflated
  std::vector<Block> blocks;
  size_t next = 0;  // the next block to inflate (under Stream::mu_)
  size_t done = 0;  // blocks inflated (under Stream::mu_)
  std::string err;  // a read or inflate error (under Stream::mu_)
};

// The counters of a stream, for the stage records.
struct Stats {
  long windows = 0, comp_bytes = 0, inflated_bytes = 0, records = 0;
  void add(const Stats& o) {
    windows += o.windows;
    comp_bytes += o.comp_bytes;
    inflated_bytes += o.inflated_bytes;
    records += o.records;
  }
};

// The inflated BAM stream of one file, a window at a time.
class Stream {
 public:
  Stream(const char* path, int threads, size_t window) : window_(window) {
    f_ = fopen(path, "rb");
    if (!f_) return;
    setvbuf(f_, nullptr, _IOFBF, 1 << 20);
    for (Window& w : win_) free_.push_back(&w);
    unsigned hw = std::thread::hardware_concurrency();
    int n = std::max(1, std::min(threads, hw ? (int)hw : threads));
    reader_ = std::thread([this] { read_windows(); });
    for (int i = 0; i < n; i++) workers_.emplace_back([this] { work(); });
  }

  ~Stream() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_) t.join();
    if (f_) fclose(f_);
  }

  bool opened() const { return f_ != nullptr; }

  // The next n bytes into dst (skipped when dst is null); false at the
  // stream's end or on an error (err non-empty).
  bool read(uint8_t* dst, size_t n) {
    while (n) {
      if (pos_ == len_ && !advance()) return false;
      size_t k = std::min(n, len_ - pos_);
      if (dst) {
        memcpy(dst, cur_ + pos_, k);
        dst += k;
      }
      pos_ += k;
      n -= k;
    }
    return true;
  }

  // The next record's bytes after its block_size, valid until the next
  // call; null at the stream's end, or on an error (err non-empty).
  const uint8_t* next_record(uint32_t* size) {
    if (pos_ + 4 <= len_) {
      int32_t bs = i32(cur_ + pos_);
      if (bs >= 0 && pos_ + 4 + (size_t)bs <= len_) {
        const uint8_t* p = cur_ + pos_ + 4;
        pos_ += 4 + (size_t)bs;
        *size = (uint32_t)bs;
        records_++;
        return p;
      }
    }
    // the record runs past this window: gather it in carry_
    carry_.assign(cur_ + pos_, cur_ + len_);
    pos_ = len_;
    size_t need = 4;
    while (true) {
      if (carry_.size() >= 4) {
        int32_t bs = i32(carry_.data());
        if (bs < 0) {
          err = "bad BAM record: negative block_size";
          return nullptr;
        }
        need = 4 + (size_t)bs;
      }
      if (carry_.size() >= need) break;
      if (pos_ == len_ && !advance()) {
        if (err.empty() && !carry_.empty())
          err = "truncated BAM file: the last record is cut off";
        return nullptr;
      }
      size_t k = std::min(need - carry_.size(), len_ - pos_);
      carry_.insert(carry_.end(), cur_ + pos_, cur_ + pos_ + k);
      pos_ += k;
    }
    *size = (uint32_t)(need - 4);
    records_++;
    return carry_.data() + 4;
  }

  // Bytes of the windows' buffers and the carry buffer.
  size_t held_bytes() const { return buf_bytes_ + carry_.capacity(); }

  // The counters; from the caller's thread (it counts the records).
  Stats snapshot() {
    std::lock_guard<std::mutex> lk(mu_);
    Stats st = stats_;
    st.records = records_;
    return st;
  }

  std::string err;

 private:
  // Hand back the parsed window and take the next inflated one.
  bool advance() {
    std::unique_lock<std::mutex> lk(mu_);
    if (cur_win_) {
      free_.push_back(cur_win_);
      cur_win_ = nullptr;
      cur_ = nullptr;
      pos_ = len_ = 0;
      cv_.notify_all();
    }
    cv_.wait(lk, [this] {
      return jobs_.empty() ? finished_ : inflated(jobs_.front());
    });
    if (jobs_.empty()) return false;
    Window* w = jobs_.front();
    jobs_.pop_front();
    if (!w->err.empty()) {
      err = w->err;
      free_.push_back(w);
      return false;
    }
    cur_win_ = w;
    cur_ = w->data.data();
    len_ = w->data.size;
    pos_ = 0;
    return true;
  }

  // Read the window's blocks: the whole blocks that start within `limit`
  // bytes. Returns false at the end of the file; a window that cannot be
  // read keeps no block and its error.
  bool load(Window* w, size_t limit) {
    w->comp.size = 0;
    w->blocks.clear();
    w->err.clear();
    auto fail = [w](const char* why) {
      w->err = why;
      w->blocks.clear();
      return true;
    };
    auto more = [this, w](size_t n) {  // n more bytes of the file
      w->comp.reserve(w->comp.size + n);
      size_t got = fread(w->comp.data() + w->comp.size, 1, n, f_);
      w->comp.size += got;
      return got;
    };
    size_t out = 0;
    while (w->comp.size < limit) {
      size_t at = w->comp.size, got = more(12);
      if (got == 0) break;  // the file ends at a block boundary
      if (got < 12) return fail("truncated BGZF block header");
      const uint8_t* h = w->comp.data() + at;
      if (h[0] != 0x1f || h[1] != 0x8b || h[2] != 8 || !(h[3] & 4))
        return fail("not a BGZF block (bad gzip header)");
      size_t xlen = u16(h + 10), bsize = 0;
      if (more(xlen) != xlen) return fail("truncated BGZF block header");
      h = w->comp.data() + at;
      for (size_t x = 12; x + 4 <= 12 + xlen; x += 4 + u16(h + x + 2))
        if (h[x] == 66 && h[x + 1] == 67 && u16(h + x + 2) == 2)
          bsize = (size_t)u16(h + x + 4) + 1;
      if (bsize < 12 + xlen + 8) return fail("not a BGZF block (no BC field)");
      if (more(bsize - 12 - xlen) != bsize - 12 - xlen)
        return fail("truncated BGZF block");
      h = w->comp.data() + at;
      uint32_t isize = u32(h + bsize - 4);
      if (isize > kMaxBlock) return fail("bad BGZF block: ISIZE over 64 KiB");
      w->blocks.push_back({at, bsize, out, isize});
      out += isize;
    }
    w->data.reserve(out);
    w->data.size = out;
    note_buffers();
    return !w->blocks.empty();
  }

  // The reader thread alone grows the windows' buffers.
  void note_buffers() {
    size_t n = 0;
    for (const Window& w : win_) n += w.comp.cap + w.data.cap;
    buf_bytes_ = n;
  }

  static bool inflated(const Window* w) {
    return w->done == w->blocks.size();
  }

  // The reader thread: loads each free window with the next blocks of the
  // file and queues it for the pool, in file order.
  void read_windows() {
    bool first = true;
    while (true) {
      Window* w;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !free_.empty(); });
        if (stop_) return;
        w = free_.front();
        free_.pop_front();
      }
      bool more = load(w, first ? 1 : window_);
      first = false;
      std::lock_guard<std::mutex> lk(mu_);
      if (more) {
        w->next = w->done = 0;
        jobs_.push_back(w);
      } else {
        free_.push_back(w);
      }
      // at the end of the file, or at a window that cannot be read (the
      // caller raises there), nothing more is read
      if (!more || !w->err.empty()) finished_ = true;
      cv_.notify_all();
      if (finished_) return;
    }
  }

  // A pool worker: inflates blocks of the queued windows, the oldest
  // window's first, and checks each block's size and CRC.
  void work() {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, -15);  // raw deflate: the gzip wrapper is parsed here
    std::unique_lock<std::mutex> lk(mu_);
    while (true) {
      Window* w = nullptr;
      cv_.wait(lk, [&] {
        for (Window* j : jobs_)
          if (j->next < j->blocks.size()) {
            w = j;
            return true;
          }
        return stop_;
      });
      if (!w) break;
      const Block& b = w->blocks[w->next++];
      lk.unlock();
      const uint8_t* in = w->comp.data() + b.in_off;
      size_t head = 12 + u16(in + 10);
      uint8_t empty;  // zlib refuses a null next_out, even for 0 bytes
      uint8_t* out = b.out_len ? w->data.data() + b.out_off : &empty;
      inflateReset(&zs);
      zs.next_in = const_cast<uint8_t*>(in + head);
      zs.avail_in = (uInt)(b.in_len - head - 8);
      zs.next_out = out;
      zs.avail_out = (uInt)b.out_len;
      const char* err = nullptr;
      if (inflate(&zs, Z_FINISH) != Z_STREAM_END || zs.total_out != b.out_len)
        err = "bad BGZF block: inflate failed";
      else if (crc32(0, out, (uInt)b.out_len) != u32(in + b.in_len - 8))
        err = "bad BGZF block: CRC mismatch";
      lk.lock();
      if (err && w->err.empty()) w->err = err;
      if (++w->done == w->blocks.size()) {
        stats_.windows++;
        stats_.comp_bytes += (long)w->comp.size;
        stats_.inflated_bytes += (long)w->data.size;
        cv_.notify_all();
      }
    }
    inflateEnd(&zs);
  }

  FILE* f_ = nullptr;
  size_t window_;
  Window win_[kWindows];
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Window*> free_, jobs_;  // jobs_: read, in file order
  bool stop_ = false, finished_ = false;
  Stats stats_;  // windows and bytes, under mu_
  std::atomic<size_t> buf_bytes_{0};
  std::thread reader_;
  std::vector<std::thread> workers_;
  // the caller's side
  Window* cur_win_ = nullptr;
  const uint8_t* cur_ = nullptr;
  size_t pos_ = 0, len_ = 0;
  std::vector<uint8_t> carry_;
  long records_ = 0;
};

// One record's fields, pointing into its bytes.
struct Rec {
  int32_t ref_id;
  uint16_t flag;
  uint32_t name_len, l_seq;
  const uint8_t *name, *seq, *qual;
};

bool parse_rec(const uint8_t* p, uint32_t size, Rec* r) {
  if (size < 32) return false;
  r->ref_id = i32(p);
  uint32_t l_read_name = p[8];
  uint32_t n_cigar = u16(p + 12);
  r->flag = u16(p + 14);
  int32_t l_seq = i32(p + 16);
  if (l_read_name < 1 || l_seq < 0) return false;
  uint64_t need = 32ull + l_read_name + 4ull * n_cigar +
                  ((uint64_t)l_seq + 1) / 2 + (uint64_t)l_seq;
  if (need > size) return false;
  r->name = p + 32;
  r->name_len = l_read_name - 1;
  r->l_seq = (uint32_t)l_seq;
  r->seq = p + 32 + l_read_name + 4 * n_cigar;
  r->qual = r->seq + (r->l_seq + 1) / 2;
  return true;
}

uint64_t hash_name(const uint8_t* p, uint32_t n) {
  uint64_t h = 0x9E3779B97F4A7C15ull ^ n;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    h = (h ^ w) * 0xff51afd7ed558ccdull;
    h ^= h >> 32;
  }
  uint64_t w = 0;
  memcpy(&w, p, n);
  h = (h ^ w) * 0xc4ceb9fe1a85ec53ull;
  return h ^ (h >> 29);
}

// The pair stream's pending mates: an open-addressing table (linear
// probing, backward-shift erase) of (name hash, arena offset). An arena
// entry is u32 size, u16 flag, u8 name length, u32 l_seq, then the name,
// the packed bases and the raw qualities. Erased entries leave holes that
// a compaction reclaims once they outweigh the live entries.
class Pending {
 public:
  static constexpr size_t kHead = 11;
  static constexpr uint64_t kEmpty = ~0ull;

  Pending() : slots_(1024, Slot{0, kEmpty}) {}

  // The slot holding `name`, or -1.
  long find(uint64_t h, const uint8_t* name, uint32_t len) const {
    size_t mask = slots_.size() - 1;
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      const Slot& s = slots_[i];
      if (s.off == kEmpty) return -1;
      const uint8_t* e = arena_.data() + s.off;
      if (s.hash == h && e[6] == len && !memcmp(e + kHead, name, len))
        return (long)i;
    }
  }

  void insert(uint64_t h, const Rec& r) {
    if ((count_ + 1) * 2 > slots_.size()) rehash(2 * slots_.size());
    if (arena_.size() > 2 * live_ + (1 << 16)) compact();
    size_t sz = kHead + r.name_len + (r.l_seq + 1) / 2 + r.l_seq;
    size_t off = arena_.size();
    arena_.resize(off + sz);
    uint8_t* e = arena_.data() + off;
    uint32_t sz32 = (uint32_t)sz;
    memcpy(e, &sz32, 4);
    memcpy(e + 4, &r.flag, 2);
    e[6] = (uint8_t)r.name_len;
    memcpy(e + 7, &r.l_seq, 4);
    memcpy(e + kHead, r.name, r.name_len);
    memcpy(e + kHead + r.name_len, r.seq, (r.l_seq + 1) / 2 + r.l_seq);
    place(Slot{h, off});
    count_++;
    live_ += sz;
    peak_ = std::max(peak_, count_);
  }

  // The pending record of slot i, as a Rec.
  Rec get(long i) const {
    const uint8_t* e = arena_.data() + slots_[(size_t)i].off;
    Rec r;
    r.ref_id = -1;
    r.flag = u16(e + 4);
    r.name_len = e[6];
    r.l_seq = u32(e + 7);
    r.name = e + kHead;
    r.seq = r.name + r.name_len;
    r.qual = r.seq + (r.l_seq + 1) / 2;
    return r;
  }

  void erase(long at) {
    size_t i = (size_t)at, mask = slots_.size() - 1;
    live_ -= u32(arena_.data() + slots_[i].off);
    count_--;
    for (size_t j = i;;) {
      slots_[i].off = kEmpty;
      while (true) {  // the next entry whose probe passes the hole at i
        j = (j + 1) & mask;
        if (slots_[j].off == kEmpty) return;
        size_t k = slots_[j].hash & mask;
        if (i <= j ? (i < k && k <= j) : (i < k || k <= j)) continue;
        break;
      }
      slots_[i] = slots_[j];
      i = j;
    }
  }

  void clear() {
    std::fill(slots_.begin(), slots_.end(), Slot{0, kEmpty});
    arena_.clear();
    count_ = live_ = 0;
  }

  size_t held_bytes() const {
    return arena_.capacity() + slots_.capacity() * sizeof(Slot);
  }
  size_t peak() const { return peak_; }

 private:
  struct Slot {
    uint64_t hash, off;
  };

  void place(Slot s) {
    size_t mask = slots_.size() - 1, i = s.hash & mask;
    while (slots_[i].off != kEmpty) i = (i + 1) & mask;
    slots_[i] = s;
  }

  void rehash(size_t n) {
    std::vector<Slot> old(n, Slot{0, kEmpty});
    old.swap(slots_);
    for (const Slot& s : old)
      if (s.off != kEmpty) place(s);
  }

  void compact() {
    std::vector<Slot*> live;
    for (Slot& s : slots_)
      if (s.off != kEmpty) live.push_back(&s);
    std::sort(live.begin(), live.end(),
              [](const Slot* a, const Slot* b) { return a->off < b->off; });
    size_t to = 0;
    for (Slot* s : live) {
      uint32_t sz = u32(arena_.data() + s->off);
      memmove(arena_.data() + to, arena_.data() + s->off, sz);
      s->off = to;
      to += sz;
    }
    arena_.resize(to);
  }

  std::vector<Slot> slots_;
  std::vector<uint8_t> arena_;
  size_t count_ = 0, live_ = 0, peak_ = 0;
};

enum Mode { kNone, kRecords, kSingle, kPairs };

struct BamFile {
  std::string path;
  int threads;
  size_t window;
  std::vector<std::string> refs;
  std::unique_ptr<Stream> s;
  Mode mode = kNone;
  Pending pending;
  std::string err;
  Stats done;              // the counters of the streams before a reset
  size_t peak_held = 0;
  std::vector<int32_t> scan_ids;
  // the reads the last batch cut at pad_len, whole, in sequencing order
  struct Long {
    long row;
    int mate;
    size_t off;
    uint32_t len;
  };
  std::vector<Long> longs;
  std::vector<uint8_t> long_bytes;  // each: bases, then quals if kept
  bool long_quals = false;
  long longest = 0;

  // A fresh stream past the header; the header's references when `refs`
  // is set. Sets err and returns null on failure.
  std::unique_ptr<Stream> open_stream(std::vector<std::string>* out_refs) {
    std::unique_ptr<Stream> st(new Stream(path.c_str(), threads, window));
    auto bad = [&](const char* why) {
      err = st->err.empty() ? why : st->err;
      return nullptr;
    };
    if (!st->opened()) return bad("cannot open the file");
    uint8_t head[8];
    if (!st->read(head, 4) || memcmp(head, "BAM\1", 4) != 0)
      return bad("not a BAM file (no BAM magic)");
    int32_t l_text, n_ref;
    if (!st->read(head, 4) || (l_text = i32(head)) < 0 ||
        !st->read(nullptr, (size_t)l_text) || !st->read(head, 4) ||
        (n_ref = i32(head)) < 0)
      return bad("truncated BAM header");
    std::string name;
    for (int32_t i = 0; i < n_ref; i++) {
      int32_t l_name;
      if (!st->read(head, 4) || (l_name = i32(head)) < 1 ||
          l_name > (1 << 20))
        return bad("truncated BAM header");
      name.resize((size_t)l_name);
      if (!st->read((uint8_t*)&name[0], (size_t)l_name) ||
          !st->read(nullptr, 4))
        return bad("truncated BAM header");
      if (out_refs) out_refs->emplace_back(name.data(), (size_t)l_name - 1);
    }
    return st;
  }

  size_t held() { return (s ? s->held_bytes() : 0) + pending.held_bytes(); }

  void close_stream() {
    if (!s) return;
    peak_held = std::max(peak_held, held());
    done.add(s->snapshot());
    s.reset();
  }

  // Start a batch of `m`: false when the handle streams another kind (one
  // stream a handle between resets).
  bool begin(Mode m, bool quals) {
    if (mode != kNone && mode != m) return false;
    mode = m;
    longs.clear();
    long_bytes.clear();
    long_quals = quals;
    longest = 0;
    return true;
  }

  // The next record not excluded; false at the end or on an error (err).
  bool next(int exclude_flags, Rec* r) {
    while (true) {
      uint32_t size;
      const uint8_t* p = s->next_record(&size);
      if (!p) {
        if (!s->err.empty()) err = s->err;
        return false;
      }
      if (!parse_rec(p, size, r)) {
        err = "bad BAM record: its fields overrun its block_size";
        return false;
      }
      if (!(r->flag & exclude_flags)) return true;
    }
  }

  // Record r into a pad_len row (stranded: flag-0x10 records reverse-
  // complemented with reversed qualities), the tail padded with 'N' and
  // '!'; a read longer than pad_len is cut there and also kept whole.
  int32_t put(const Rec& r, bool stranded, uint8_t* so, uint8_t* qo,
              long pad_len, long row, int mate) {
    bool rev = stranded && (r.flag & 0x10);
    uint32_t n = r.l_seq < (uint64_t)pad_len ? r.l_seq : (uint32_t)pad_len;
    decode_seq(r.seq, r.l_seq, rev, so, n);
    memset(so + n, 'N', (size_t)(pad_len - n));
    if (qo) {
      decode_qual(r.qual, r.l_seq, rev, qo, n);
      memset(qo + n, '!', (size_t)(pad_len - n));
    }
    longest = std::max(longest, (long)r.l_seq);
    if (r.l_seq > n) {
      size_t off = long_bytes.size();
      long_bytes.resize(off + (qo ? 2 : 1) * (size_t)r.l_seq);
      decode_seq(r.seq, r.l_seq, rev, long_bytes.data() + off, r.l_seq);
      if (qo)
        decode_qual(r.qual, r.l_seq, rev, long_bytes.data() + off + r.l_seq,
                    r.l_seq);
      longs.push_back({row, mate, off, r.l_seq});
    }
    return (int32_t)n;
  }
};

}  // namespace

extern "C" {

// Opens `path` and reads its header; a window is the whole blocks that
// start within `window` bytes of compressed input (the first: one block).
// Null on failure, the reason in err.
void* bam_open(const char* path, int threads, long window, char* err,
               long err_cap) {
  BamFile* bf = new BamFile();
  bf->path = path;
  bf->threads = threads > 0 ? threads : 1;
  bf->window = window > 0 ? (size_t)window : 1;
  bf->s = bf->open_stream(&bf->refs);
  if (!bf->s) {
    snprintf(err, (size_t)err_cap, "%s", bf->err.c_str());
    delete bf;
    return nullptr;
  }
  return bf;
}

const char* bam_error(void* h) { return ((BamFile*)h)->err.c_str(); }

// Records as stored (the exclude_flags-filtered pass-through feeding the
// count), cut at pad_len into (capacity x pad_len) row-major seq, and qual
// when it is not null. Returns the reads written (0 at the end), -1 on an
// error (bam_error), -2 when the handle streams another kind of batch.
long bam_read_batch(void* h, int exclude_flags, uint8_t* seq, uint8_t* qual,
                    int32_t* lens, long capacity, long pad_len) {
  BamFile* bf = (BamFile*)h;
  if (!bf->s || !bf->err.empty()) return -1;  // errors stay
  if (!bf->begin(kRecords, qual != nullptr)) return -2;
  long written = 0;
  Rec r;
  while (written < capacity && bf->next(exclude_flags, &r)) {
    lens[written] = bf->put(r, false, seq + written * pad_len,
                            qual ? qual + written * pad_len : nullptr,
                            pad_len, written, 0);
    written++;
  }
  return bf->err.empty() ? written : -1;
}

// Single-end stranded pass-through batch (PassThroughSamCheck.stranded.se
// role, io/bam.py::bam_to_single_fastq): every record not excluded, in
// file order, in sequencing orientation, with its name (packed bytes in
// name_buf, name_lens gives each length). Returns as bam_read_batch.
long bam_read_se_batch(void* h, int exclude_flags, uint8_t* seq,
                       uint8_t* qual, int32_t* lens, uint8_t* name_buf,
                       long name_cap, int32_t* name_lens, long capacity,
                       long pad_len) {
  BamFile* bf = (BamFile*)h;
  if (!bf->s || !bf->err.empty()) return -1;  // errors stay
  if (!bf->begin(kSingle, qual != nullptr)) return -2;
  if (name_cap < capacity * 255) {
    bf->err = "name buffer under 255 bytes a read";
    return -1;
  }
  long written = 0, name_off = 0;
  Rec r;
  while (written < capacity && bf->next(exclude_flags, &r)) {
    memcpy(name_buf + name_off, r.name, r.name_len);
    name_lens[written] = (int32_t)r.name_len;
    name_off += r.name_len;
    lens[written] = bf->put(r, true, seq + written * pad_len,
                            qual ? qual + written * pad_len : nullptr,
                            pad_len, written, 0);
    written++;
  }
  return bf->err.empty() ? written : -1;
}

// Paired pass-through batch (PassThroughSamCheck.stranded.cpp:192-279
// role): pairs matched by name; flag-0x10 records are reverse-complemented
// back to sequencing orientation with reversed quals; the SECOND record
// seen for a name becomes mate1, the stashed first mate2 — identical
// semantics to io/bam.py::bam_to_paired_fastq, whose kept-read-name parity
// the filter tests pin. Names are packed in name_buf (name_lens gives each
// length). Returns as bam_read_batch; unpaired leftovers stay pending.
long bam_read_pair_batch(void* h, int exclude_flags,
                         uint8_t* seq1, uint8_t* qual1, int32_t* len1,
                         uint8_t* seq2, uint8_t* qual2, int32_t* len2,
                         uint8_t* name_buf, long name_cap,
                         int32_t* name_lens,
                         long capacity, long pad_len) {
  BamFile* bf = (BamFile*)h;
  if (!bf->s || !bf->err.empty()) return -1;  // errors stay
  if (!bf->begin(kPairs, qual1 != nullptr)) return -2;
  if (name_cap < capacity * 255) {
    bf->err = "name buffer under 255 bytes a pair";
    return -1;
  }
  long written = 0, name_off = 0;
  Rec r;
  while (written < capacity && bf->next(exclude_flags, &r)) {
    uint64_t hash = hash_name(r.name, r.name_len);
    long at = bf->pending.find(hash, r.name, r.name_len);
    if (at < 0) {
      bf->pending.insert(hash, r);
      continue;
    }
    memcpy(name_buf + name_off, r.name, r.name_len);
    name_lens[written] = (int32_t)r.name_len;
    name_off += r.name_len;
    long row = written * pad_len;
    len1[written] = bf->put(r, true, seq1 + row, qual1 ? qual1 + row : nullptr,
                            pad_len, written, 0);
    len2[written] = bf->put(bf->pending.get(at), true, seq2 + row,
                            qual2 ? qual2 + row : nullptr, pad_len, written,
                            1);
    bf->pending.erase(at);
    written++;
  }
  return bf->err.empty() ? written : -1;
}

// The longest read (whole) among those the last batch call wrote.
long bam_longest(void* h) { return ((BamFile*)h)->longest; }

// Writes the reads the last batch cut at its pad_len into rows of pad_len
// (wider) arrays holding the batch, cut at pad_len now, and sets their
// lengths; mate 1's arrays are seq2/qual2/len2 (null for a single-end or
// record batch).
void bam_put_long(void* h, uint8_t* seq1, uint8_t* qual1, int32_t* len1,
                  uint8_t* seq2, uint8_t* qual2, int32_t* len2,
                  long pad_len) {
  BamFile* bf = (BamFile*)h;
  for (const BamFile::Long& l : bf->longs) {
    uint8_t* so = l.mate ? seq2 : seq1;
    uint8_t* qo = l.mate ? qual2 : qual1;
    int32_t* lo = l.mate ? len2 : len1;
    uint32_t n = l.len < (uint64_t)pad_len ? l.len : (uint32_t)pad_len;
    memcpy(so + l.row * pad_len, bf->long_bytes.data() + l.off, n);
    if (qo && bf->long_quals)
      memcpy(qo + l.row * pad_len, bf->long_bytes.data() + l.off + l.len, n);
    lo[l.row] = (int32_t)n;
  }
}

// Rewinds to the first record; any kind of batch may follow. 0, or -1.
long bam_reset(void* h) {
  BamFile* bf = (BamFile*)h;
  bf->close_stream();
  bf->pending.clear();
  bf->mode = kNone;
  bf->longs.clear();
  bf->long_bytes.clear();
  bf->longest = 0;
  bf->err.clear();
  bf->s = bf->open_stream(nullptr);
  return bf->s ? 0 : -1;
}

// The stream's counters, summed over resets: windows inflated, compressed
// and inflated bytes, records parsed, the peak bytes held (windows, carry
// and pending mates) and the peak number of pending mates.
void bam_stats(void* h, long* out) {
  BamFile* bf = (BamFile*)h;
  Stats st = bf->done;
  if (bf->s) st.add(bf->s->snapshot());
  bf->peak_held = std::max(bf->peak_held, bf->held());
  out[0] = st.windows;
  out[1] = st.comp_bytes;
  out[2] = st.inflated_bytes;
  out[3] = st.records;
  out[4] = (long)bf->peak_held;
  out[5] = (long)bf->pending.peak();
}

// A pass of its own over the file (the batch stream is left where it is):
// returns the number of records, or -1; *max_len gets the longest read
// among records not excluded. With keep_ids, every record's ref_id is
// kept for bam_scan_ids.
long bam_scan(void* h, int exclude_flags, int keep_ids, long* max_len) {
  BamFile* bf = (BamFile*)h;
  std::string saved = bf->err;
  std::unique_ptr<Stream> st = bf->open_stream(nullptr);
  if (!st) return -1;
  bf->err = saved;
  bf->scan_ids.clear();
  long n = 0, m = 0;
  uint32_t size;
  while (const uint8_t* p = st->next_record(&size)) {
    Rec r;
    if (!parse_rec(p, size, &r)) {
      bf->err = "bad BAM record: its fields overrun its block_size";
      return -1;
    }
    if (!(r.flag & exclude_flags)) m = std::max(m, (long)r.l_seq);
    if (keep_ids) bf->scan_ids.push_back(r.ref_id);
    n++;
  }
  if (!st->err.empty()) {
    bf->err = st->err;
    return -1;
  }
  *max_len = m;
  return n;
}

// The ref_ids the last bam_scan kept, into out (its count of them).
void bam_scan_ids(void* h, int32_t* out) {
  BamFile* bf = (BamFile*)h;
  std::copy(bf->scan_ids.begin(), bf->scan_ids.end(), out);
  std::vector<int32_t>().swap(bf->scan_ids);
}

long bam_num_refs(void* h) { return (long)((BamFile*)h)->refs.size(); }

// Reference i's name into buf (not NUL-terminated); returns its length, or
// -1 when it does not fit cap.
long bam_ref_name(void* h, long i, char* buf, long cap) {
  const std::string& s = ((BamFile*)h)->refs[(size_t)i];
  if ((long)s.size() > cap) return -1;
  memcpy(buf, s.data(), s.size());
  return (long)s.size();
}

void bam_close(void* h) { delete (BamFile*)h; }
}
