// The port's copy of bonsai_tpu/native/src/fastx.cpp, which also trims a
// '/<digit>' mate suffix off each name (trim_readno below).
// Native FASTA/FASTQ batch reader + 2-bit encoder.
//
// TPU-native replacement for the reference's kseq/bseq input layer
// (reference klib kseq.h + include/bonsai/kseq_declare.h:39-204): the
// device consumes fixed-shape (B, L) int8 code batches, so the host
// parser's job is to stream records and marshal them straight into padded
// code matrices with no per-read interpreter work.  gzread handles both
// plain and gzip inputs (the Python layer routes .xz/.bz2/.zst through its
// own decompressors and feeds this parser via a pipe path when needed).
//
// Batch protocol (ctypes, see bonsai_tpu/native/__init__.py):
//   h = btpu_fastx_open(path)
//   n = btpu_next_batch(h, max_reads)        // parse into internal buffers
//   btpu_batch_info(h, &name_bytes, &seq_bytes, &qual_bytes, &maxlen)
//   btpu_batch_fill(h, ...)                  // copy out + LUT-encode
//   btpu_fastx_close(h)

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Record {
  size_t name_off, name_len;
  size_t seq_off, seq_len;
  size_t qual_off, qual_len;
  bool has_qual;
};

struct Reader {
  gzFile f = nullptr;
  std::string err;
  // stream buffer
  std::vector<char> buf;
  size_t pos = 0, lim = 0;
  bool eof = false;
  int format = 0;  // 0 unknown, 1 fasta, 2 fastq
  // current batch storage
  std::string names, seqs, quals;
  std::vector<Record> recs;
  // pending FASTA header (consumed '>' line that starts the next record)
  std::string pending_name;
  bool have_pending = false;

  int fill() {
    if (eof) return 0;
    pos = 0;
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n < 0) {
      err = "gzread failed";
      eof = true;
      lim = 0;
      return -1;
    }
    lim = (size_t)n;
    if (n == 0) eof = true;
    return n;
  }

  // append the next line (without terminator) to out; returns false at EOF
  bool getline(std::string &out) {
    bool got = false;
    for (;;) {
      if (pos >= lim) {
        if (fill() <= 0) return got;
      }
      char *start = buf.data() + pos;
      char *nl = (char *)memchr(start, '\n', lim - pos);
      if (nl) {
        size_t len = (size_t)(nl - start);
        if (len && start[len - 1] == '\r') --len;
        out.append(start, len);
        pos += (size_t)(nl - start) + 1;
        return true;
      }
      out.append(start, lim - pos);
      pos = lim;
      got = true;
    }
  }
};

void trim_name(std::string &s) {
  // header up to first space/tab (matching the Python parser / kseq)
  size_t cut = s.find_first_of(" \t");
  if (cut != std::string::npos) s.resize(cut);
}

void trim_readno(std::string &s) {
  // a '/<digit>' mate suffix off a name longer than 2 bytes
  // (kseq_declare.h trim_readno; io/fastx.py trim_readno)
  size_t n = s.size();
  if (n > 2 && s[n - 2] == '/' && s[n - 1] >= '0' && s[n - 1] <= '9')
    s.resize(n - 2);
}

}  // namespace

extern "C" {

void *btpu_fastx_open(const char *path) {
  Reader *r = new Reader();
  r->f = gzopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  gzbuffer(r->f, 1 << 20);
  r->buf.resize(1 << 20);
  return r;
}

void btpu_fastx_close(void *h) {
  Reader *r = (Reader *)h;
  if (!r) return;
  if (r->f) gzclose(r->f);
  delete r;
}

// Parse up to max_reads records into internal buffers.
// Returns n >= 0, or -1 on malformed input / read error.
int64_t btpu_next_batch(void *h, int64_t max_reads) {
  Reader *r = (Reader *)h;
  r->names.clear();
  r->seqs.clear();
  r->quals.clear();
  r->recs.clear();
  std::string line;
  for (int64_t i = 0; i < max_reads; ++i) {
    // find record start
    std::string name;
    if (r->have_pending) {
      name.swap(r->pending_name);
      r->have_pending = false;
    } else {
      line.clear();
      if (!r->getline(line)) break;  // EOF
      while (line.empty()) {
        line.clear();
        if (!r->getline(line)) return (int64_t)r->recs.size();
      }
      char c = line[0];
      if (c == '>') {
        if (r->format == 2) {
          r->err = "mixed fasta/fastq";
          return -1;
        }
        r->format = 1;
      } else if (c == '@') {
        if (r->format == 1) {
          r->err = "mixed fasta/fastq";
          return -1;
        }
        r->format = 2;
      } else {
        r->err = "not FASTA/FASTQ";
        return -1;
      }
      name.assign(line, 1, std::string::npos);
    }
    trim_name(name);
    trim_readno(name);

    Record rec;
    rec.name_off = r->names.size();
    rec.name_len = name.size();
    r->names += name;
    rec.seq_off = r->seqs.size();

    if (r->format == 1) {
      // FASTA: lines until next '>' or EOF
      for (;;) {
        line.clear();
        if (!r->getline(line)) break;
        if (!line.empty() && line[0] == '>') {
          r->pending_name.assign(line, 1, std::string::npos);
          r->have_pending = true;
          break;
        }
        r->seqs += line;
      }
      rec.seq_len = r->seqs.size() - rec.seq_off;
      rec.has_qual = false;
      rec.qual_off = rec.qual_len = 0;
    } else {
      // FASTQ: seq lines until '+', then qual until length matches
      for (;;) {
        line.clear();
        if (!r->getline(line)) {
          r->err = "truncated fastq record";
          return -1;
        }
        if (!line.empty() && line[0] == '+') break;
        r->seqs += line;
      }
      rec.seq_len = r->seqs.size() - rec.seq_off;
      rec.qual_off = r->quals.size();
      while (r->quals.size() - rec.qual_off < rec.seq_len) {
        line.clear();
        if (!r->getline(line)) {
          r->err = "truncated fastq quality";
          return -1;
        }
        r->quals += line;
      }
      rec.qual_len = r->quals.size() - rec.qual_off;
      if (rec.qual_len != rec.seq_len) {
        r->err = "quality length mismatch";
        return -1;
      }
      rec.has_qual = true;
    }
    r->recs.push_back(rec);
  }
  return (int64_t)r->recs.size();
}

const char *btpu_last_error(void *h) { return ((Reader *)h)->err.c_str(); }

void btpu_batch_info(void *h, int64_t *name_bytes, int64_t *seq_bytes,
                     int64_t *qual_bytes, int32_t *maxlen, int32_t *has_qual) {
  Reader *r = (Reader *)h;
  *name_bytes = (int64_t)r->names.size();
  *seq_bytes = (int64_t)r->seqs.size();
  *qual_bytes = (int64_t)r->quals.size();
  int64_t m = 0;
  int hq = 0;
  for (const Record &rec : r->recs) {
    if ((int64_t)rec.seq_len > m) m = (int64_t)rec.seq_len;
    hq |= rec.has_qual;
  }
  *maxlen = (int32_t)m;
  *has_qual = hq;
}

// Copy out the parsed batch and encode codes through lut.
//   names/seqs/quals: byte arenas (sizes from btpu_batch_info)
//   offs arrays: (n+1,) exclusive prefix offsets per arena
//   lut: 256-entry int8 map (char -> code, -1 ambiguous)
//   codes: (n, L) int8, pre-filled by caller or overwritten fully here
//   lengths: (n,) int32
void btpu_batch_fill(void *h, uint8_t *names, int64_t *name_offs,
                     uint8_t *seqs, int64_t *seq_offs, uint8_t *quals,
                     int64_t *qual_offs, const int8_t *lut, int8_t *codes,
                     int64_t L, int32_t *lengths) {
  Reader *r = (Reader *)h;
  memcpy(names, r->names.data(), r->names.size());
  memcpy(seqs, r->seqs.data(), r->seqs.size());
  memcpy(quals, r->quals.data(), r->quals.size());
  const char *sbase = r->seqs.data();
  int64_t i = 0;
  for (const Record &rec : r->recs) {
    name_offs[i] = (int64_t)rec.name_off;
    seq_offs[i] = (int64_t)rec.seq_off;
    qual_offs[i] = rec.has_qual ? (int64_t)rec.qual_off : -1;
    lengths[i] = (int32_t)rec.seq_len;
    int8_t *row = codes + i * L;
    const uint8_t *sp = (const uint8_t *)sbase + rec.seq_off;
    int64_t n = (int64_t)rec.seq_len;
    if (n > L) n = L;
    for (int64_t j = 0; j < n; ++j) row[j] = lut[sp[j]];
    if (n < L) memset(row + n, 0xFF, (size_t)(L - n));  // -1 pad
    ++i;
  }
  name_offs[i] = (int64_t)r->names.size();
  seq_offs[i] = (int64_t)r->seqs.size();
  qual_offs[i] = (int64_t)r->quals.size();
}

}  // extern "C"
