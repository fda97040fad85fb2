// Native BAM/BGZF decoder for the rufus_tpu_torch host I/O runtime.
//
// Replaces the pure-Python BGZF+BAM parser (rufus_tpu_torch/io/bam.py,
// its plain version) on the hot path: BAM decode is CPU-bound and must
// keep the card fed (reference pipeline equivalent: samtools view -F 3328
// | PassThroughSamCheck, runRufus.sh:595-658). Exposed via a C ABI for
// ctypes, built with the host compiler at first use (ops/_build.py).
//
// API (see rufus_tpu_torch/io/native.py):
//   bam_open(path) -> handle          (decompresses + indexes records)
//   bam_read_batch(handle, ...)       (fills fixed-shape uint8 matrices,
//                                      ready for device upload)
//   bam_read_pair_batch / bam_read_se_batch (stranded pair and single-end
//                                      pass-through, with names)
//   bam_num_refs, bam_ref_name, bam_ref_ids, bam_max_seq_len (header and
//                                      record metadata)
//   bam_close(handle)
//
// Decompression uses zlib's raw inflate per BGZF block; blocks are
// decoded in a simple worker pool sized by `threads`.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct BamRecordView {
  int32_t ref_id;
  int32_t pos;
  uint16_t flag;
  uint8_t mapq;
  // offsets into the arena: 64-bit, since the arena passes 4 GiB at about
  // 14 M records of 150 bases
  uint64_t name_off;
  uint32_t name_len;
  uint64_t seq_off;    // decoded ASCII bases in arena
  uint32_t seq_len;
  uint64_t qual_off;   // phred+33 in arena
};

struct BamFile {
  std::vector<uint8_t> data;       // fully decompressed BAM stream
  std::vector<BamRecordView> recs; // parsed record table
  std::vector<uint8_t> arena;      // names + decoded seq + qual
  std::vector<std::string> refs;
  size_t cursor = 0;               // batch iteration state
  // pair-stream state (PassThroughSamCheck.stranded role)
  size_t pair_cursor = 0;
  std::unordered_map<std::string, uint32_t> pending;
};

const char SEQ_CODES[17] = "=ACMGRSVTWYHKDBN";

bool bgzf_decompress_all(const char* path, std::vector<uint8_t>& out, int threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw((size_t)fsize);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return false;
  }
  fclose(f);

  // index BGZF blocks: gzip members with BC extra field giving BSIZE
  struct Block { size_t in_off; size_t in_len; size_t out_off; size_t out_len; };
  std::vector<Block> blocks;
  size_t off = 0;
  size_t total_out = 0;
  while (off + 18 <= raw.size()) {
    if (raw[off] != 0x1f || raw[off + 1] != 0x8b) return false;
    uint16_t xlen = (uint16_t)(raw[off + 10] | (raw[off + 11] << 8));
    size_t xoff = off + 12;
    size_t bsize = 0;
    size_t xend = xoff + xlen;
    while (xoff + 4 <= xend) {
      uint8_t si1 = raw[xoff], si2 = raw[xoff + 1];
      uint16_t slen = (uint16_t)(raw[xoff + 2] | (raw[xoff + 3] << 8));
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (size_t)(raw[xoff + 4] | (raw[xoff + 5] << 8)) + 1;
      }
      xoff += 4 + slen;
    }
    if (bsize == 0) return false;  // not BGZF
    // ISIZE: last 4 bytes of the member
    size_t end = off + bsize;
    if (end > raw.size()) return false;
    uint32_t isize;
    memcpy(&isize, raw.data() + end - 4, 4);
    blocks.push_back({off, bsize, total_out, isize});
    total_out += isize;
    off = end;
    if (isize == 0 && bsize == 28) break;  // EOF block
  }
  out.resize(total_out);

  std::atomic<size_t> next{0};
  auto worker = [&]() {
    z_stream zs;
    while (true) {
      size_t bi = next.fetch_add(1);
      if (bi >= blocks.size()) break;
      const Block& b = blocks[bi];
      if (b.out_len == 0) continue;
      memset(&zs, 0, sizeof(zs));
      inflateInit2(&zs, -15);  // raw deflate; skip 12-byte gzip hdr + xlen
      uint16_t xlen = (uint16_t)(raw[b.in_off + 10] | (raw[b.in_off + 11] << 8));
      size_t payload = b.in_off + 12 + xlen;
      zs.next_in = raw.data() + payload;
      zs.avail_in = (uInt)(b.in_len - 12 - xlen - 8);
      zs.next_out = out.data() + b.out_off;
      zs.avail_out = (uInt)b.out_len;
      inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
    }
  };
  int n_threads = threads > 0 ? threads : 1;
  std::vector<std::thread> pool;
  for (int i = 0; i < n_threads; i++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return true;
}

bool parse_bam(BamFile* bf) {
  const std::vector<uint8_t>& d = bf->data;
  if (d.size() < 8 || memcmp(d.data(), "BAM\1", 4) != 0) return false;
  size_t off = 4;
  int32_t l_text;
  memcpy(&l_text, d.data() + off, 4);
  off += 4 + (size_t)l_text;
  int32_t n_ref;
  memcpy(&n_ref, d.data() + off, 4);
  off += 4;
  for (int i = 0; i < n_ref; i++) {
    int32_t l_name;
    memcpy(&l_name, d.data() + off, 4);
    off += 4;
    bf->refs.emplace_back((const char*)d.data() + off, (size_t)l_name - 1);
    off += (size_t)l_name + 4;  // name + l_ref
  }
  bf->arena.reserve(d.size());
  while (off + 4 <= d.size()) {
    int32_t block_size;
    memcpy(&block_size, d.data() + off, 4);
    off += 4;
    if (block_size <= 0 || off + (size_t)block_size > d.size()) break;
    const uint8_t* p = d.data() + off;
    BamRecordView r;
    memcpy(&r.ref_id, p, 4);
    memcpy(&r.pos, p + 4, 4);
    uint8_t l_read_name = p[8];
    r.mapq = p[9];
    uint16_t n_cigar;
    memcpy(&n_cigar, p + 12, 2);
    memcpy(&r.flag, p + 14, 2);
    int32_t l_seq;
    memcpy(&l_seq, p + 16, 4);
    const uint8_t* q = p + 32;
    r.name_off = bf->arena.size();
    r.name_len = l_read_name - 1;
    bf->arena.insert(bf->arena.end(), q, q + r.name_len);
    q += l_read_name;
    q += 4ull * n_cigar;
    r.seq_off = bf->arena.size();
    r.seq_len = (uint32_t)l_seq;
    for (int32_t i = 0; i < l_seq; i++) {
      uint8_t b = q[i / 2];
      uint8_t code = (i % 2 == 0) ? (b >> 4) : (b & 0xF);
      bf->arena.push_back((uint8_t)SEQ_CODES[code]);
    }
    q += (l_seq + 1) / 2;
    r.qual_off = bf->arena.size();
    for (int32_t i = 0; i < l_seq; i++) {
      uint8_t qq = q[i];
      bf->arena.push_back((uint8_t)(qq == 0xFF ? '*' : qq + 33));
    }
    bf->recs.push_back(r);
    off += (size_t)block_size;
  }
  return true;
}

// Up to pad_len bases and quals of r in sequencing orientation: flag-0x10
// records are reverse-complemented with reversed quals (the stranded
// pass-through, PassThroughSamCheck.stranded.cpp). Returns the count.
int32_t put_stranded(const BamFile* bf, const BamRecordView& r, uint8_t* so,
                     uint8_t* qo, long pad_len) {
  long n = r.seq_len < (uint32_t)pad_len ? r.seq_len : pad_len;
  const uint8_t* s = bf->arena.data() + r.seq_off;
  const uint8_t* q = bf->arena.data() + r.qual_off;
  if (r.flag & 0x10) {
    for (long i = 0; i < n; i++) {
      uint8_t b = s[r.seq_len - 1 - i];
      uint8_t c;
      switch (b) {
        case 'A': c = 'T'; break;
        case 'C': c = 'G'; break;
        case 'G': c = 'C'; break;
        case 'T': c = 'A'; break;
        case 'a': c = 't'; break;
        case 'c': c = 'g'; break;
        case 'g': c = 'c'; break;
        case 't': c = 'a'; break;
        default: c = b;
      }
      so[i] = c;
      qo[i] = q[r.seq_len - 1 - i];
    }
  } else {
    memcpy(so, s, (size_t)n);
    memcpy(qo, q, (size_t)n);
  }
  return (int32_t)n;
}

}  // namespace

extern "C" {

void* bam_open(const char* path, int threads) {
  BamFile* bf = new BamFile();
  if (!bgzf_decompress_all(path, bf->data, threads) || !parse_bam(bf)) {
    delete bf;
    return nullptr;
  }
  return bf;
}

long bam_num_records(void* h) { return (long)((BamFile*)h)->recs.size(); }

// Fill a fixed-shape batch of reads (exclude_flags-filtered pass-through,
// the PassThroughSamCheck role). Returns number of reads written; advances
// the internal cursor. seq/qual are (capacity x pad_len) row-major uint8,
// pre-filled by caller (e.g. with 'N' / '!').
long bam_read_batch(void* h, int exclude_flags, uint8_t* seq, uint8_t* qual,
                    int32_t* lens, long capacity, long pad_len) {
  BamFile* bf = (BamFile*)h;
  long written = 0;
  while (written < capacity && bf->cursor < bf->recs.size()) {
    const BamRecordView& r = bf->recs[bf->cursor++];
    if (r.flag & exclude_flags) continue;
    long n = r.seq_len < (uint32_t)pad_len ? r.seq_len : pad_len;
    memcpy(seq + written * pad_len, bf->arena.data() + r.seq_off, (size_t)n);
    memcpy(qual + written * pad_len, bf->arena.data() + r.qual_off, (size_t)n);
    lens[written] = (int32_t)n;
    written++;
  }
  return written;
}

void bam_reset(void* h) {
  BamFile* bf = (BamFile*)h;
  bf->cursor = 0;
  bf->pair_cursor = 0;
  bf->pending.clear();
}

// Paired pass-through batch (PassThroughSamCheck.stranded.cpp:192-279
// role): pairs matched by a name hashmap; flag-0x10 records are
// reverse-complemented back to sequencing orientation with reversed
// quals; the SECOND record seen for a name becomes mate1, the stashed
// first mate2 — identical semantics to io/bam.py::bam_to_paired_fastq,
// whose kept-read-name parity the filter tests pin. Names are packed as
// '\n'-joined bytes in name_buf (name_lens gives each length).
// Returns pairs written; unpaired leftovers stay pending.
long bam_read_pair_batch(void* h, int exclude_flags,
                         uint8_t* seq1, uint8_t* qual1, int32_t* len1,
                         uint8_t* seq2, uint8_t* qual2, int32_t* len2,
                         uint8_t* name_buf, long name_cap,
                         int32_t* name_lens,
                         long capacity, long pad_len) {
  BamFile* bf = (BamFile*)h;
  long written = 0;
  long name_off = 0;
  auto emit = [&](const BamRecordView& r, uint8_t* seq, uint8_t* qual,
                  int32_t* lens) {
    lens[written] = put_stranded(bf, r, seq + written * pad_len,
                                 qual + written * pad_len, pad_len);
  };
  while (written < capacity && bf->pair_cursor < bf->recs.size()) {
    uint32_t idx = (uint32_t)bf->pair_cursor++;
    const BamRecordView& r = bf->recs[idx];
    if (r.flag & exclude_flags) continue;
    std::string name((const char*)bf->arena.data() + r.name_off, r.name_len);
    auto it = bf->pending.find(name);
    if (it == bf->pending.end()) {
      bf->pending.emplace(std::move(name), idx);
      continue;
    }
    if (name_off + (long)r.name_len > name_cap) {
      bf->pair_cursor--;  // retry this record next call; mate stays pending
      break;
    }
    const BamRecordView& first = bf->recs[it->second];
    bf->pending.erase(it);
    memcpy(name_buf + name_off, bf->arena.data() + r.name_off, r.name_len);
    name_lens[written] = (int32_t)r.name_len;
    name_off += r.name_len;
    emit(r, seq1, qual1, len1);       // second seen -> mate1
    emit(first, seq2, qual2, len2);   // stashed first -> mate2
    written++;
  }
  return written;
}

// Random access to record metadata for the Python record API.
void bam_record_info(void* h, long i, int32_t* ref_id, int32_t* pos,
                     int32_t* flag, int32_t* mapq, int32_t* seq_len) {
  const BamRecordView& r = ((BamFile*)h)->recs[(size_t)i];
  *ref_id = r.ref_id;
  *pos = r.pos;
  *flag = r.flag;
  *mapq = r.mapq;
  *seq_len = (int32_t)r.seq_len;
}

long bam_record_fields(void* h, long i, uint8_t* name_buf, long name_cap,
                       uint8_t* seq_buf, long seq_cap, uint8_t* qual_buf,
                       long qual_cap) {
  BamFile* bf = (BamFile*)h;
  const BamRecordView& r = bf->recs[(size_t)i];
  long nl = r.name_len < (uint32_t)name_cap ? r.name_len : name_cap;
  memcpy(name_buf, bf->arena.data() + r.name_off, (size_t)nl);
  long sl = r.seq_len < (uint32_t)seq_cap ? r.seq_len : seq_cap;
  memcpy(seq_buf, bf->arena.data() + r.seq_off, (size_t)sl);
  long ql = r.seq_len < (uint32_t)qual_cap ? r.seq_len : qual_cap;
  memcpy(qual_buf, bf->arena.data() + r.qual_off, (size_t)ql);
  return nl;
}

// Single-end stranded pass-through batch (PassThroughSamCheck.stranded.se
// role, io/bam.py::bam_to_single_fastq): every record not excluded, in
// file order, in sequencing orientation, with its name (packed bytes in
// name_buf, name_lens gives each length). Shares the cursor of
// bam_read_batch. Returns reads written.
long bam_read_se_batch(void* h, int exclude_flags, uint8_t* seq,
                       uint8_t* qual, int32_t* lens, uint8_t* name_buf,
                       long name_cap, int32_t* name_lens, long capacity,
                       long pad_len) {
  BamFile* bf = (BamFile*)h;
  long written = 0;
  long name_off = 0;
  while (written < capacity && bf->cursor < bf->recs.size()) {
    const BamRecordView& r = bf->recs[bf->cursor];
    if (r.flag & exclude_flags) {
      bf->cursor++;
      continue;
    }
    if (name_off + (long)r.name_len > name_cap) break;  // next call
    bf->cursor++;
    memcpy(name_buf + name_off, bf->arena.data() + r.name_off, r.name_len);
    name_lens[written] = (int32_t)r.name_len;
    name_off += r.name_len;
    lens[written] = put_stranded(bf, r, seq + written * pad_len,
                                 qual + written * pad_len, pad_len);
    written++;
  }
  return written;
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

// The ref_id of every record, in file order (out holds bam_num_records).
void bam_ref_ids(void* h, int32_t* out) {
  const BamFile* bf = (BamFile*)h;
  for (size_t i = 0; i < bf->recs.size(); i++) out[i] = bf->recs[i].ref_id;
}

// The longest read among records not excluded (0 when there is none).
long bam_max_seq_len(void* h, int exclude_flags) {
  const BamFile* bf = (BamFile*)h;
  long m = 0;
  for (const BamRecordView& r : bf->recs)
    if (!(r.flag & exclude_flags) && (long)r.seq_len > m) m = (long)r.seq_len;
  return m;
}

void bam_close(void* h) { delete (BamFile*)h; }
}
