// Native BAM scanner: BGZF inflate + record field extraction.
//
// Produces the columnar alignment table (chrom id, start, end, read name,
// mapq, strand, cigar) that svscope_tpu.io.bam.AlignmentTable serves to the
// selection/feature stages — the whole-genome ingest path, where the Python
// per-record parser would be the bottleneck.  Sequences/qualities are
// skipped here; per-window read payloads are fetched lazily by the Python
// reader over the (small) candidate regions.
//
// Scale design (30x WGS, multi-GB BAMs):
//   * the file is mmap'd (bam_scan_open_path) — no Python-side read
//   * a BGZF block index (compressed offset, uncompressed offset per
//     block) is built by a header walk, then blocks inflate in parallel
//     (each BGZF block is an independent deflate stream) in bounded
//     chunks while a streaming parser consumes records — peak memory is
//     O(chunk), not O(uncompressed file)
//   * lazy mode keeps only the compressed source + block index + per-
//     record virtual offsets; per-window sequence decode inflates just
//     the touched blocks (htslib BAI-equivalent random access)
//
// C ABI: bam_scan_open* parse the whole file into an in-memory table;
// accessors copy columns out; strings are exposed as one concatenated
// buffer + offsets.
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Table {
  std::vector<std::string> refs;
  std::vector<int64_t> ref_len;
  std::vector<int32_t> ref_id;
  std::vector<int64_t> start;
  std::vector<int64_t> end;
  std::vector<int32_t> mapq;
  std::vector<int32_t> flag;
  std::vector<uint32_t> name_off;   // offsets into names (n+1 entries)
  std::string names;
  std::vector<uint32_t> cigar_off;  // offsets into cigars (n+1 entries)
  std::string cigars;
  std::string error;

  // lazy random access: compressed source + BGZF block index + per-record
  // virtual (uncompressed-stream) offsets
  std::string comp_owned;           // owned copy (buffer-based open)
  const uint8_t* comp = nullptr;    // source bytes (owned or mmap)
  size_t comp_len = 0;
  void* map_addr = nullptr;         // mmap bookkeeping
  size_t map_len = 0;
  int fd = -1;
  std::vector<uint64_t> blk_coff;   // per block, +1 sentinel
  std::vector<uint64_t> blk_uoff;   // per block, +1 sentinel
  std::vector<uint64_t> rec_off;    // uncompressed offset of each record
  // single-span decode cache for per-window fetches
  std::string cache;
  uint64_t cache_u0 = 0, cache_u1 = 0;

  ~Table() {
    if (map_addr) munmap(map_addr, map_len);
    if (fd >= 0) close(fd);
  }
};

// Walk BGZF block headers (no inflate): fills blk_coff/blk_uoff.
bool index_blocks(Table* t) {
  const uint8_t* d = t->comp;
  size_t n = t->comp_len;
  size_t pos = 0;
  uint64_t u = 0;
  while (pos + 18 <= n) {
    if (d[pos] != 0x1f || d[pos + 1] != 0x8b) return false;
    uint16_t xlen = d[pos + 10] | (d[pos + 11] << 8);
    size_t epos = pos + 12, eend = epos + xlen;
    int64_t bsize = -1;
    while (epos + 4 <= eend) {
      uint8_t si1 = d[epos], si2 = d[epos + 1];
      uint16_t slen = d[epos + 2] | (d[epos + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2)
        bsize = (int64_t)(d[epos + 4] | (d[epos + 5] << 8)) + 1;
      epos += 4 + slen;
    }
    if (bsize < 0 || pos + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, d + pos + bsize - 4, 4);
    t->blk_coff.push_back(pos);
    t->blk_uoff.push_back(u);
    u += isize;
    pos += bsize;
  }
  t->blk_coff.push_back(pos);
  t->blk_uoff.push_back(u);
  // a valid BGZF stream has at least one block (the EOF marker counts)
  return t->blk_coff.size() >= 2;
}

// Inflate block b into out (sized for it).
bool inflate_block(const Table* t, size_t b, uint8_t* out) {
  const uint8_t* d = t->comp + t->blk_coff[b];
  size_t bsize = t->blk_coff[b + 1] - t->blk_coff[b];
  uint32_t isize = (uint32_t)(t->blk_uoff[b + 1] - t->blk_uoff[b]);
  if (isize == 0) return true;
  uint16_t xlen = d[10] | (d[11] << 8);
  const uint8_t* cdata = d + 12 + xlen;
  size_t clen = bsize - 12 - xlen - 8;
  z_stream zs{};
  inflateInit2(&zs, -15);
  zs.next_in = const_cast<uint8_t*>(cdata);
  zs.avail_in = (uInt)clen;
  zs.next_out = out;
  zs.avail_out = isize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// Inflate blocks [b0, b1) in parallel into a contiguous buffer whose first
// byte corresponds to blk_uoff[b0].
bool inflate_span(const Table* t, size_t b0, size_t b1, uint8_t* out,
                  int n_threads) {
  std::atomic<size_t> next(b0);
  std::atomic<bool> ok(true);
  auto work = [&]() {
    for (size_t b = next.fetch_add(1); b < b1; b = next.fetch_add(1)) {
      if (!inflate_block(t, b, out + (t->blk_uoff[b] - t->blk_uoff[b0])))
        ok = false;
    }
  };
  if (n_threads <= 1 || b1 - b0 <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    int nt = std::min<int>(n_threads, (int)(b1 - b0));
    for (int k = 0; k < nt; k++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return ok;
}

const char kCigarOps[] = "MIDNSHP=X";
// reference-consuming ops: M D N = X
const bool kRefConsume[9] = {true, false, true, true, false,
                             false, false, true, true};

constexpr size_t kChunkBlocks = 512;   // ~33 MB uncompressed per chunk

// Streaming parse over chunked parallel inflate.
void parse_stream(Table* t, bool lazy, int n_threads) {
  if (!index_blocks(t)) {
    t->error = "bad BGZF stream";
    return;
  }
  size_t nb = t->blk_coff.size() - 1;
  std::string buf;
  uint64_t base = 0;     // virtual offset of buf[0]
  size_t pos = 0;        // parse cursor within buf
  size_t next_blk = 0;
  bool header_done = false;
  t->name_off.push_back(0);
  t->cigar_off.push_back(0);
  char numbuf[16];

  auto rd_i32 = [&](size_t o) {
    int32_t v;
    memcpy(&v, buf.data() + o, 4);
    return v;
  };

  while (next_blk < nb || pos < buf.size()) {
    // top up the buffer with the next chunk of blocks
    if (next_blk < nb) {
      size_t b1 = std::min(next_blk + kChunkBlocks, nb);
      size_t add = t->blk_uoff[b1] - t->blk_uoff[next_blk];
      size_t old = buf.size();
      buf.resize(old + add);
      if (!inflate_span(t, next_blk, b1, (uint8_t*)buf.data() + old,
                        n_threads)) {
        t->error = "bad BGZF stream";
        return;
      }
      next_blk = b1;
    }
    if (!header_done) {
      if (buf.size() < 8) {
        if (next_blk >= nb) { t->error = "not a BAM file"; return; }
        continue;
      }
      if (memcmp(buf.data(), "BAM\x01", 4) != 0) {
        t->error = "not a BAM file";
        return;
      }
      uint32_t l_text = (uint32_t)rd_i32(4);
      if (buf.size() < 12 + (size_t)l_text) {
        if (next_blk >= nb) { t->error = "truncated BAM header"; return; }
        continue;
      }
      size_t off = 8 + l_text;
      int32_t n_ref = rd_i32(off);
      off += 4;
      bool ok = true;
      size_t probe = off;
      for (int r = 0; r < n_ref; r++) {
        if (probe + 4 > buf.size()) { ok = false; break; }
        int32_t l_name = rd_i32(probe);
        probe += 4 + l_name + 4;
        if (probe > buf.size()) { ok = false; break; }
      }
      if (!ok) {
        if (next_blk >= nb) { t->error = "truncated BAM header"; return; }
        continue;
      }
      for (int r = 0; r < n_ref; r++) {
        int32_t l_name = rd_i32(off);
        off += 4;
        t->refs.emplace_back(buf.data() + off, l_name - 1);
        off += l_name;
        t->ref_len.push_back(rd_i32(off));
        off += 4;
      }
      pos = off;
      header_done = true;
    }
    // parse complete records
    while (pos + 4 <= buf.size()) {
      int32_t block_size = rd_i32(pos);
      size_t rec = pos + 4;
      if (rec + (size_t)block_size > buf.size()) break;
      size_t nextpos = rec + block_size;
      int32_t ref_id = rd_i32(rec);
      int32_t rpos = rd_i32(rec + 4);
      uint8_t l_read_name = (uint8_t)buf[rec + 8];
      uint8_t mapq = (uint8_t)buf[rec + 9];
      uint16_t n_cigar;
      memcpy(&n_cigar, buf.data() + rec + 12, 2);
      uint16_t flag;
      memcpy(&flag, buf.data() + rec + 14, 2);
      pos = nextpos;
      if (ref_id < 0 || (flag & 0x4)) continue;  // unmapped
      if (lazy) t->rec_off.push_back(base + rec);
      t->ref_id.push_back(ref_id);
      t->start.push_back(rpos);
      t->mapq.push_back(mapq);
      t->flag.push_back(flag);
      t->names.append(buf.data() + rec + 32, l_read_name - 1);
      t->name_off.push_back((uint32_t)t->names.size());
      size_t coff = rec + 32 + l_read_name;
      int32_t l_seq;
      memcpy(&l_seq, buf.data() + rec + 16, 4);
      const uint8_t* cig_ptr = (const uint8_t*)buf.data() + coff;
      uint32_t n_ops = n_cigar;
      // >65535-op alignments store a kSmN placeholder in-record and the
      // real CIGAR in the CG:B,I aux tag (SAM spec 4.2.2)
      if (n_cigar == 2 && l_seq > 0) {
        uint32_t c0, c1;
        memcpy(&c0, cig_ptr, 4);
        memcpy(&c1, cig_ptr + 4, 4);
        if ((c0 & 0xF) == 4 && (int32_t)(c0 >> 4) == l_seq
            && (c1 & 0xF) == 3) {
          size_t aux = coff + 8ull + ((size_t)l_seq + 1) / 2 + l_seq;
          size_t rec_end = rec + block_size;
          while (aux + 4 <= rec_end) {
            char tg0 = buf[aux], tg1 = buf[aux + 1], ty = buf[aux + 2];
            size_t payload = aux + 3;
            size_t sz;
            if (ty == 'A' || ty == 'c' || ty == 'C') sz = 1;
            else if (ty == 's' || ty == 'S') sz = 2;
            else if (ty == 'i' || ty == 'I' || ty == 'f') sz = 4;
            else if (ty == 'Z' || ty == 'H') {
              sz = 0;
              while (payload + sz < rec_end && buf[payload + sz]) sz++;
              sz++;
            } else if (ty == 'B') {
              char sub = buf[payload];
              uint32_t cnt;
              memcpy(&cnt, buf.data() + payload + 1, 4);
              size_t esz = (sub == 'c' || sub == 'C') ? 1
                           : (sub == 's' || sub == 'S') ? 2 : 4;
              if (tg0 == 'C' && tg1 == 'G' && sub == 'I') {
                cig_ptr = (const uint8_t*)buf.data() + payload + 5;
                n_ops = cnt;
                break;
              }
              sz = 5 + (size_t)cnt * esz;
            } else {
              break;  // unknown type: stop walking
            }
            aux = payload + sz;
          }
        }
      }
      int64_t ref_span = 0;
      for (uint32_t k = 0; k < n_ops; k++) {
        uint32_t c;
        memcpy(&c, cig_ptr + 4ull * k, 4);
        uint32_t op = c & 0xF;
        uint32_t len = c >> 4;
        if (op < 9 && kRefConsume[op]) ref_span += len;
        int nn = snprintf(numbuf, sizeof numbuf, "%u", len);
        t->cigars.append(numbuf, nn);
        t->cigars.push_back(op < 9 ? kCigarOps[op] : '?');
      }
      t->cigar_off.push_back((uint32_t)t->cigars.size());
      t->end.push_back(rpos + ref_span);
    }
    // once every block is inflated, the parse loop above consumed every
    // complete record; anything left is a truncated trailer
    if (next_blk >= nb) break;
    // drop the consumed prefix to keep memory bounded
    if (pos > (kChunkBlocks << 16)) {
      buf.erase(0, pos);
      base += pos;
      pos = 0;
    }
  }
  if (!lazy) {
    // nothing kept beyond the columns
    t->blk_coff.clear();
    t->blk_coff.shrink_to_fit();
    t->blk_uoff.clear();
    t->blk_uoff.shrink_to_fit();
  }
}

// Ensure the uncompressed range [u0, u0+len) is in t->cache.
bool ensure_range(Table* t, uint64_t u0, uint64_t len) {
  if (u0 >= t->cache_u0 && u0 + len <= t->cache_u1) return true;
  if (t->blk_uoff.empty()) return false;
  // blocks covering [u0, u0+len), extended forward for locality
  auto it = std::upper_bound(t->blk_uoff.begin(), t->blk_uoff.end(), u0);
  size_t b0 = (size_t)(it - t->blk_uoff.begin()) - 1;
  size_t nb = t->blk_coff.size() - 1;
  if (b0 >= nb) return false;
  size_t b1 = b0;
  uint64_t target = u0 + len;
  while (b1 < nb && t->blk_uoff[b1] < target) b1++;
  b1 = std::min(b1 + 8, nb);   // read ahead a few blocks
  t->cache.resize(t->blk_uoff[b1] - t->blk_uoff[b0]);
  if (!inflate_span(t, b0, b1, (uint8_t*)t->cache.data(), 1)) return false;
  t->cache_u0 = t->blk_uoff[b0];
  t->cache_u1 = t->blk_uoff[b1];
  return u0 >= t->cache_u0 && u0 + len <= t->cache_u1;
}

const char kSeqNt16[] = "=ACMGRSVTWYHKDBN";

}  // namespace

extern "C" {

void* bam_scan_open_threads(const uint8_t* raw, int64_t rawlen, int32_t lazy,
                            int32_t n_threads) {
  auto* t = new Table();
  if (lazy) {
    t->comp_owned.assign((const char*)raw, (size_t)rawlen);
    t->comp = (const uint8_t*)t->comp_owned.data();
  } else {
    t->comp = raw;
  }
  t->comp_len = (size_t)rawlen;
  parse_stream(t, lazy, n_threads);
  if (!lazy) t->comp = nullptr;
  return t;
}

void* bam_scan_open(const uint8_t* raw, int64_t rawlen) {
  return bam_scan_open_threads(raw, rawlen, 0, 4);
}

void* bam_scan_open_lazy(const uint8_t* raw, int64_t rawlen) {
  return bam_scan_open_threads(raw, rawlen, 1, 4);
}

// mmap-backed open: no caller-side file read, lazy mode retains only the
// mapping + block index + record offsets
void* bam_scan_open_path(const char* path, int32_t lazy, int32_t n_threads) {
  auto* t = new Table();
  t->fd = open(path, O_RDONLY);
  if (t->fd < 0) {
    t->error = "cannot open file";
    return t;
  }
  struct stat st;
  if (fstat(t->fd, &st) != 0 || st.st_size == 0) {
    t->error = "cannot stat file";
    return t;
  }
  t->map_len = (size_t)st.st_size;
  t->map_addr = mmap(nullptr, t->map_len, PROT_READ, MAP_PRIVATE, t->fd, 0);
  if (t->map_addr == MAP_FAILED) {
    t->map_addr = nullptr;
    t->error = "mmap failed";
    return t;
  }
  madvise(t->map_addr, t->map_len, MADV_SEQUENTIAL);
  t->comp = (const uint8_t*)t->map_addr;
  t->comp_len = t->map_len;
  parse_stream(t, lazy, n_threads);
  if (!lazy) {
    munmap(t->map_addr, t->map_len);
    t->map_addr = nullptr;
    close(t->fd);
    t->fd = -1;
    t->comp = nullptr;
    t->comp_len = 0;
  } else {
    madvise(t->map_addr, t->map_len, MADV_RANDOM);
  }
  return t;
}

// decode record idx's sequence (soft clips included); returns length or -1
int64_t bam_scan_record_seq(void* h, int64_t idx, char* out, int64_t cap) {
  Table* t = (Table*)h;
  if (t->comp == nullptr || idx < 0 || idx >= (int64_t)t->rec_off.size())
    return -1;
  uint64_t rec = t->rec_off[idx];
  if (!ensure_range(t, rec, 36)) return -1;
  const char* p = t->cache.data() + (rec - t->cache_u0);
  uint8_t l_read_name = (uint8_t)p[8];
  uint16_t n_cigar;
  memcpy(&n_cigar, p + 12, 2);
  int32_t l_seq;
  memcpy(&l_seq, p + 16, 4);
  if (l_seq > cap) return -((int64_t)l_seq + 1);  // caller grows + retries
  uint64_t seq_off = rec + 32 + l_read_name + 4ull * n_cigar;
  uint64_t seq_bytes = ((uint64_t)l_seq + 1) / 2;
  if (!ensure_range(t, seq_off, seq_bytes)) return -1;
  const uint8_t* packed =
      (const uint8_t*)t->cache.data() + (seq_off - t->cache_u0);
  for (int32_t k = 0; k < l_seq; k++) {
    uint8_t code = (k & 1) ? (packed[k >> 1] & 0xF) : (packed[k >> 1] >> 4);
    out[k] = kSeqNt16[code];
  }
  return l_seq;
}

void bam_scan_free(void* h) { delete (Table*)h; }

const char* bam_scan_error(void* h) {
  Table* t = (Table*)h;
  return t->error.empty() ? nullptr : t->error.c_str();
}

int64_t bam_scan_n_records(void* h) { return ((Table*)h)->ref_id.size(); }
int32_t bam_scan_n_refs(void* h) { return (int32_t)((Table*)h)->refs.size(); }

int32_t bam_scan_ref_name(void* h, int32_t i, char* out, int32_t cap) {
  const std::string& s = ((Table*)h)->refs[i];
  if ((int32_t)s.size() + 1 > cap) return -1;
  memcpy(out, s.c_str(), s.size() + 1);
  return (int32_t)s.size();
}

int64_t bam_scan_ref_length(void* h, int32_t i) {
  return ((Table*)h)->ref_len[i];
}

void bam_scan_columns(void* h, int32_t* ref_id, int64_t* start, int64_t* end,
                      int32_t* mapq, int32_t* flag) {
  Table* t = (Table*)h;
  size_t n = t->ref_id.size();
  memcpy(ref_id, t->ref_id.data(), n * 4);
  memcpy(start, t->start.data(), n * 8);
  memcpy(end, t->end.data(), n * 8);
  memcpy(mapq, t->mapq.data(), n * 4);
  memcpy(flag, t->flag.data(), n * 4);
}

int64_t bam_scan_names_size(void* h) { return ((Table*)h)->names.size(); }
int64_t bam_scan_cigars_size(void* h) { return ((Table*)h)->cigars.size(); }

void bam_scan_strings(void* h, uint8_t* names, uint32_t* name_off,
                      uint8_t* cigars, uint32_t* cigar_off) {
  Table* t = (Table*)h;
  memcpy(names, t->names.data(), t->names.size());
  memcpy(name_off, t->name_off.data(), t->name_off.size() * 4);
  memcpy(cigars, t->cigars.data(), t->cigars.size());
  memcpy(cigar_off, t->cigar_off.data(), t->cigar_off.size() * 4);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Breakpoint extraction (WindowSelection GetSpanReads/ParseCLIP semantics,
// specified by svscope_tpu/select/breakpoints.py; parity-tested there).
// Emits one row per DEL>=indel_cutoff, INS>=indel_cutoff, CLIP>=clip_cutoff:
//   rec_idx, bp_type (0 DEL / 1 INS / 2 CLIP), ref_start, ref_end,
//   read_start, read_end, region_start, region_end
// where (region_start, region_end) is the aligned-block read span used for
// the row's readRegion string (strand-reversed coordinates for CLIP rows).
// ---------------------------------------------------------------------------

struct BpRows {
  std::vector<int64_t> rec_idx;
  std::vector<int32_t> bp_type;
  std::vector<int64_t> ref_start, ref_end, read_start, read_end;
  std::vector<int64_t> region_start, region_end;
};

namespace {

void extract_bp(Table* t, int64_t i, int indel_cutoff, int clip_cutoff,
                BpRows& out, std::vector<uint32_t>& lens,
                std::vector<char>& ops) {
  const char* c = t->cigars.data() + t->cigar_off[i];
  const char* cend = t->cigars.data() + t->cigar_off[i + 1];
  lens.clear();
  ops.clear();
  uint32_t num = 0;
  for (const char* p = c; p < cend; p++) {
    if (*p >= '0' && *p <= '9') {
      num = num * 10 + (*p - '0');
    } else {
      lens.push_back(num);
      ops.push_back(*p);
      num = 0;
    }
  }
  int n = (int)ops.size();
  auto is_m = [](char o) { return o == 'M' || o == '=' || o == 'X'; };
  int first_m = -1, last_m = -1;
  for (int k = 0; k < n; k++)
    if (is_m(ops[k])) {
      if (first_m < 0) first_m = k;
      last_m = k;
    }
  if (first_m < 0) return;
  auto is_refgrow = [](char o) { return o == 'D' || o == 'P' || o == 'N'; };
  int64_t read_start_aln = 0;
  for (int k = 0; k < first_m; k++) read_start_aln += lens[k];
  int64_t read_end_aln = 0;
  for (int k = 0; k <= last_m; k++)
    if (!is_refgrow(ops[k])) read_end_aln += lens[k];
  int64_t start = t->start[i];
  bool rev = (t->flag[i] & 0x10) != 0;
  // DEL / INS with the reference's ref-walk readstart
  int64_t ref_before = 0;
  for (int k = 0; k < n; k++) {
    char o = ops[k];
    bool ismatch = is_m(o);
    if ((o == 'D' || o == 'I') && (int)lens[k] >= indel_cutoff) {
      int64_t rs = start + ref_before;
      out.rec_idx.push_back(i);
      out.bp_type.push_back(o == 'D' ? 0 : 1);
      out.ref_start.push_back(rs);
      out.ref_end.push_back(o == 'D' ? rs + lens[k] : rs);
      out.read_start.push_back(ref_before);
      out.read_end.push_back(o == 'D' ? ref_before : ref_before + lens[k]);
      out.region_start.push_back(read_start_aln);
      out.region_end.push_back(read_end_aln);
    }
    if (ismatch || is_refgrow(o)) ref_before += lens[k];
  }
  // CLIP on the strand-reversed cigar
  int fm = -1, lm = -1;
  auto opAt = [&](int k) { return rev ? ops[n - 1 - k] : ops[k]; };
  auto lenAt = [&](int k) { return lens[rev ? n - 1 - k : k]; };
  for (int k = 0; k < n; k++)
    if (is_m(opAt(k))) {
      if (fm < 0) fm = k;
      lm = k;
    }
  int64_t rs_c = 0;
  for (int k = 0; k < fm; k++) rs_c += lenAt(k);
  int64_t re_c = 0;
  for (int k = 0; k <= lm; k++)
    if (!is_refgrow(opAt(k))) re_c += lenAt(k);
  for (int k = 0; k < n; k++) {
    char o = opAt(k);
    if ((o == 'S' || o == 'H') && (int)lenAt(k) >= clip_cutoff) {
      int64_t refpos, readpos;
      if (k == 0) {
        refpos = rev ? t->end[i] : start;
        readpos = rs_c;
      } else {
        refpos = rev ? start : t->end[i];
        readpos = re_c;
      }
      out.rec_idx.push_back(i);
      out.bp_type.push_back(2);
      out.ref_start.push_back(refpos);
      out.ref_end.push_back(refpos);
      out.read_start.push_back(readpos);
      out.read_end.push_back(readpos);
      out.region_start.push_back(rs_c);
      out.region_end.push_back(re_c);
    }
  }
}

}  // namespace

extern "C" {

void* bam_scan_breakpoints(void* h, int32_t indel_cutoff,
                           int32_t clip_cutoff) {
  Table* t = (Table*)h;
  auto* out = new BpRows();
  std::vector<uint32_t> lens;
  std::vector<char> ops;
  for (int64_t i = 0; i < (int64_t)t->ref_id.size(); i++)
    extract_bp(t, i, indel_cutoff, clip_cutoff, *out, lens, ops);
  return out;
}

int64_t bp_rows_count(void* b) { return ((BpRows*)b)->rec_idx.size(); }

void bp_rows_columns(void* b, int64_t* rec_idx, int32_t* bp_type,
                     int64_t* ref_start, int64_t* ref_end,
                     int64_t* read_start, int64_t* read_end,
                     int64_t* region_start, int64_t* region_end) {
  BpRows* r = (BpRows*)b;
  size_t n = r->rec_idx.size();
  memcpy(rec_idx, r->rec_idx.data(), n * 8);
  memcpy(bp_type, r->bp_type.data(), n * 4);
  memcpy(ref_start, r->ref_start.data(), n * 8);
  memcpy(ref_end, r->ref_end.data(), n * 8);
  memcpy(read_start, r->read_start.data(), n * 8);
  memcpy(read_end, r->read_end.data(), n * 8);
  memcpy(region_start, r->region_start.data(), n * 8);
  memcpy(region_end, r->region_end.data(), n * 8);
}

void bp_rows_free(void* b) { delete (BpRows*)b; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Span-site computation (FetchAimRegion semantics, specified by
// svscope_tpu/select/windows.py::_read_span_sites; parity-tested there):
// full-read coordinates of the window boundaries inside one alignment
// record.  Batched over (record, window) jobs so the RoughCompare span
// test runs as one native pass instead of a per-record Python CIGAR walk.
// ---------------------------------------------------------------------------

extern "C" {

void span_sites_batch(const uint8_t* cig_blob, const int64_t* cig_off,
                      const int64_t* cig_len, const int64_t* aln_start,
                      const int64_t* win_start, const int64_t* win_end,
                      int64_t n_jobs, int64_t* out_s5, int64_t* out_s3) {
  std::vector<uint32_t> lens;
  std::vector<char> ops;
  std::vector<int64_t> ref_loci, read_loci;
  for (int64_t jb = 0; jb < n_jobs; jb++) {
    const char* c = (const char*)cig_blob + cig_off[jb];
    const char* cend = c + cig_len[jb];
    lens.clear();
    ops.clear();
    uint32_t num = 0;
    for (const char* p = c; p < cend; p++) {
      if (*p >= '0' && *p <= '9') {
        num = num * 10 + (*p - '0');
      } else {
        lens.push_back(num);
        ops.push_back(*p);
        num = 0;
      }
    }
    int n = (int)ops.size();
    auto ref_grow = [](char o) {
      return o == 'D' || o == 'P' || o == 'N' || o == 'M' || o == '=' ||
             o == 'X';
    };
    auto read_grow = [](char o) {
      return o == 'H' || o == 'S' || o == 'I' || o == 'M' || o == '=' ||
             o == 'X';
    };
    int64_t a0 = aln_start[jb];
    ref_loci.assign(1, a0);
    read_loci.assign(1, 0);
    for (int k = 0; k < n; k++) {
      ref_loci.push_back(ref_loci.back() + (ref_grow(ops[k]) ? lens[k] : 0));
      read_loci.push_back(read_loci.back()
                          + (read_grow(ops[k]) ? lens[k] : 0));
    }
    int first_m = -1, last_m = -1;
    for (int k = 0; k < n; k++)
      if (ops[k] == 'M' || ops[k] == '=' || ops[k] == 'X') {
        if (first_m < 0) first_m = k;
        last_m = k;
      }
    if (first_m < 0) {  // no aligned block: degenerate record
      out_s5[jb] = 0;
      out_s3[jb] = 0;
      continue;
    }
    int64_t read_start_aln = 0;
    for (int k = 0; k < first_m; k++) read_start_aln += lens[k];
    int64_t read_end_aln = 0;
    for (int k = 0; k <= last_m; k++)
      if (!(ops[k] == 'D' || ops[k] == 'P' || ops[k] == 'N'))
        read_end_aln += lens[k];
    int64_t aln_end = ref_loci.back();
    int64_t ws = win_start[jb], we = win_end[jb];
    if (a0 < ws) {
      int t5 = 0;
      for (int k = (int)ref_loci.size() - 1; k >= 0; k--)
        if (ref_loci[k] <= ws) { t5 = k; break; }
      out_s5[jb] = read_loci[t5] + (ws - ref_loci[t5]);
    } else {
      out_s5[jb] = read_start_aln;
    }
    if (aln_end > we) {
      int t3 = 0;
      for (int k = (int)ref_loci.size() - 1; k >= 0; k--)
        if (ref_loci[k] <= we) { t3 = k; break; }
      out_s3[jb] = read_loci[t3] + (we - ref_loci[t3]);
    } else {
      out_s3[jb] = read_end_aln;
    }
  }
}

}  // extern "C"
