// cxxnet native IO for the PyTorch port: threaded binary-page reader +
// JPEG decode pool, the JAX package's reader (native/cxxnet_io.cc) line
// for line.
//
// The reference's two-stage ThreadBuffer pipeline
// (src/io/iter_thread_imbin_x-inl.hpp: a page thread streaming 64MB
// BinaryPages + a decode thread doing JPEG->HWC) as a bounded-queue
// pipeline: one reader thread (sequential page reads, the CXBP and
// BinaryPage formats of cxxnet_tpu_torch/io/imgbin.py) feeding N libjpeg
// decode workers whose results are re-ordered to .lst order.
//
// C ABI (ctypes-consumed by cxxnet_tpu_torch/io/native.py):
//   cxio_open(paths, ndecode) / cxio_reset / cxio_next / cxio_kind
//   cxio_shape / cxio_size / cxio_copy / cxio_close
// Records whose blob is not JPEG are passed through undecoded (kind=0);
// the Python side decodes those with PIL.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

namespace {

constexpr uint32_t kPageMagic = 0x43584250;  // "CXBP"
// the reference's BinaryPage: (64<<18) i32s = 64 MiB exactly (io.h:226)
constexpr size_t kRefPageBytes = (64u << 18) * 4;
constexpr size_t kInQueueCap = 512;          // encoded blobs in flight
// Sanity bounds on untrusted on-disk length fields: a 64 MB page format
// cannot legitimately exceed these; reject instead of bad_alloc-ing.
constexpr uint32_t kMaxRecordsPerPage = 1u << 24;
constexpr uint32_t kMaxRecordBytes = 1u << 30;
constexpr size_t kOutWindowCap = 256;        // decoded images buffered

struct Record {
  uint64_t seq = 0;
  std::vector<uint8_t> blob;   // encoded (or raw) bytes
  std::vector<uint8_t> pixels; // decoded HWC u8 (empty if kind==0)
  int h = 0, w = 0, c = 0;
  int kind = 0;                // 1 decoded, 0 pass-through blob
};

// ---------------------------------------------------------------------------
// libjpeg decode with longjmp error recovery (decoder.h:20-110 analog).
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool DecodeJpeg(const std::vector<uint8_t>& blob, Record* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob.data()), blob.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = static_cast<int>(cinfo.output_width);
  out->h = static_cast<int>(cinfo.output_height);
  out->c = 3;
  out->pixels.resize(static_cast<size_t>(out->h) * out->w * 3);
  const size_t stride = static_cast<size_t>(out->w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->pixels.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out->kind = 1;
  return true;
}

bool LooksLikeJpeg(const std::vector<uint8_t>& b) {
  return b.size() > 3 && b[0] == 0xFF && b[1] == 0xD8;
}

// ---------------------------------------------------------------------------
class Pipeline {
 public:
  Pipeline(std::vector<std::string> paths, int ndecode)
      : paths_(std::move(paths)),
        ndecode_(ndecode < 1 ? 1 : ndecode) {}

  ~Pipeline() { Stop(); }

  void Start() {
    Stop();
    stop_ = false;
    reader_done_ = false;
    eof_seq_ = UINT64_MAX;
    consume_seq_ = 0;
    in_.clear();
    out_.clear();
    reader_ = std::thread([this] { ReadLoop(); });
    for (int i = 0; i < ndecode_; ++i)
      workers_.emplace_back([this] { DecodeLoop(); });
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_in_.notify_all();
    cv_out_.notify_all();
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
  }

  // Blocks until the next in-order record is decoded; false at EOF.
  bool Next(Record* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_out_.wait(lk, [this] {
      return stop_ || out_.count(consume_seq_) || consume_seq_ >= eof_seq_;
    });
    if (stop_ || consume_seq_ >= eof_seq_) return false;
    *out = std::move(out_[consume_seq_]);
    out_.erase(consume_seq_);
    ++consume_seq_;
    cv_out_.notify_all();  // window freed: wake decoders
    return true;
  }

  // Set once the reader hits a missing/corrupt shard; never cleared by
  // later records, so the consumer sees it even after draining.
  std::string Error() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_;
  }

 private:
  void ReadLoop() {
    // Length fields come from untrusted on-disk pages: an exception escaping
    // a std::thread is std::terminate, so route every failure (including
    // bad_alloc from a corrupt nrec/len) into error_ for the Python side.
    try {
      ReadLoopImpl();
    } catch (const std::exception& e) {
      std::lock_guard<std::mutex> lk(mu_);
      if (error_.empty()) error_ = std::string("page reader: ") + e.what();
      eof_seq_ = consume_seq_;  // Next() returns false; consumer reads Error()
      reader_done_ = true;
      cv_in_.notify_all();
      cv_out_.notify_all();
    }
  }

  // Blocks until queue space frees; false when the pipeline is stopping.
  bool PushRecord(Record&& r) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_in_.wait(lk, [this] { return stop_ || in_.size() < kInQueueCap; });
    if (stop_) return false;
    in_.push_back(std::move(r));
    cv_in_.notify_all();
    return true;
  }

  // Parse one reference-format BinaryPage (io.h:225-300): `first` is the
  // already-consumed record count (the page's leading i32), the 0 that
  // followed it was cumulative-offset[0].  Blob r spans bytes
  // [page_end - off[r+1], page_end - off[r]).  Returns 1 ok, 0 corrupt
  // (err set), -1 pipeline stopping.
  int ReadRefPage(FILE* f, uint32_t first, const std::string& path,
                  uint64_t* seq, std::string* err) {
    const uint32_t nrec = first;
    if (nrec > kMaxRecordsPerPage ||
        (static_cast<size_t>(nrec) + 2) * 4 > kRefPageBytes) {
      *err = "corrupt reference page (record count) in shard: " + path;
      return 0;
    }
    std::vector<uint8_t> page(kRefPageBytes);
    std::memcpy(page.data(), &nrec, 4);
    std::memset(page.data() + 4, 0, 4);
    if (std::fread(page.data() + 8, 1, kRefPageBytes - 8, f) !=
        kRefPageBytes - 8) {
      *err = "truncated reference page in shard: " + path;
      return 0;
    }
    std::vector<int32_t> offs(nrec + 1);
    std::memcpy(offs.data(), page.data() + 4, (nrec + 1) * 4);
    for (uint32_t r = 0; r < nrec; ++r) {
      const int64_t lo = offs[r], hi = offs[r + 1];
      if (lo < 0 || hi < lo ||
          hi + (static_cast<int64_t>(nrec) + 2) * 4 >
              static_cast<int64_t>(kRefPageBytes)) {
        *err = "corrupt reference page offsets in shard: " + path;
        return 0;
      }
      Record rec;
      rec.seq = *seq;
      rec.blob.assign(page.data() + kRefPageBytes - hi,
                      page.data() + kRefPageBytes - lo);
      if (!PushRecord(std::move(rec))) return -1;
      ++*seq;
    }
    return 1;
  }

  void ReadLoopImpl() {
    uint64_t seq = 0;
    std::string err;
    for (const auto& path : paths_) {
      FILE* f = std::fopen(path.c_str(), "rb");
      if (!f) {
        err = "cannot open shard: " + path;
        break;
      }
      bool shard_ok = true;
      bool stopped = false;
      for (;;) {
        uint32_t hdr[2];
        size_t got = std::fread(hdr, sizeof(uint32_t), 2, f);
        if (got == 0) break;  // clean EOF
        if (got == 2 && hdr[0] != kPageMagic) {
          // auto-detect the reference BinaryPage bit-format (io.h:225-300):
          // pages lead with the record count, not a magic, and the first
          // cumulative offset is always 0
          int rc = (hdr[1] == 0)
                       ? ReadRefPage(f, hdr[0], path, &seq, &err)
                       : 0;
          if (rc == 0) {
            if (err.empty())
              err = "corrupt page header in shard: " + path;
            shard_ok = false;
            break;
          }
          if (rc < 0) {
            stopped = true;
            break;
          }
          continue;
        }
        if (got != 2) {
          err = "corrupt page header in shard: " + path;
          shard_ok = false;
          break;
        }
        uint32_t nrec = hdr[1];
        if (nrec > kMaxRecordsPerPage) {
          err = "corrupt page (record count) in shard: " + path;
          shard_ok = false;
          break;
        }
        std::vector<uint32_t> lens(nrec);
        if (nrec && std::fread(lens.data(), sizeof(uint32_t), nrec, f) != nrec) {
          err = "truncated page in shard: " + path;
          shard_ok = false;
          break;
        }
        for (uint32_t i = 0; i < nrec && shard_ok; ++i) {
          if (lens[i] > kMaxRecordBytes) {
            err = "corrupt record length in shard: " + path;
            shard_ok = false;
            break;
          }
          Record r;
          r.seq = seq;
          r.blob.resize(lens[i]);
          if (std::fread(r.blob.data(), 1, lens[i], f) != lens[i]) {
            err = "truncated record in shard: " + path;
            shard_ok = false;
            break;
          }
          if (!PushRecord(std::move(r))) {
            stopped = true;
            break;
          }
          ++seq;
        }
        if (!shard_ok || stopped) break;
      }
      std::fclose(f);
      if (stopped) return;
      if (!shard_ok) break;
    }
    std::lock_guard<std::mutex> lk(mu_);
    if (!err.empty()) error_ = err;
    eof_seq_ = seq;
    reader_done_ = true;
    cv_in_.notify_all();
    cv_out_.notify_all();
  }

  void DecodeLoop() {
    for (;;) {
      Record r;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_in_.wait(lk, [this] { return stop_ || !in_.empty() || reader_done_; });
        if (stop_) return;
        if (in_.empty()) return;  // reader done and drained
        r = std::move(in_.front());
        in_.pop_front();
        cv_in_.notify_all();
      }
      if (!LooksLikeJpeg(r.blob) || !DecodeJpeg(r.blob, &r)) {
        r.kind = 0;  // pass through; Python decodes
      } else {
        r.blob.clear();
        r.blob.shrink_to_fit();
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_out_.wait(lk, [this, &r] {
        return stop_ || out_.size() < kOutWindowCap || r.seq == consume_seq_;
      });
      if (stop_) return;
      out_.emplace(r.seq, std::move(r));
      cv_out_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  int ndecode_;
  std::thread reader_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_in_, cv_out_;
  std::deque<Record> in_;
  std::map<uint64_t, Record> out_;
  bool stop_ = true;
  bool reader_done_ = false;
  std::string error_;
  uint64_t eof_seq_ = UINT64_MAX;
  uint64_t consume_seq_ = 0;
};

struct Handle {
  Pipeline* pipe = nullptr;
  Record cur;
  std::string err_buf;
};

}  // namespace

extern "C" {

void* cxio_open(const char* paths_nl, int ndecode) {
  std::vector<std::string> paths;
  std::string s(paths_nl ? paths_nl : "");
  size_t pos = 0;
  while (pos < s.size()) {
    size_t nl = s.find('\n', pos);
    if (nl == std::string::npos) nl = s.size();
    if (nl > pos) paths.emplace_back(s.substr(pos, nl - pos));
    pos = nl + 1;
  }
  if (paths.empty()) return nullptr;
  auto* h = new Handle();
  h->pipe = new Pipeline(std::move(paths), ndecode);
  h->pipe->Start();
  return h;
}

void cxio_reset(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  h->pipe->Start();
}

// Returns the persistent reader error ("" when healthy).  The returned
// buffer lives in the handle and is valid until the next call.
const char* cxio_error(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  h->err_buf = h->pipe->Error();
  return h->err_buf.c_str();
}

int cxio_next(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  return h->pipe->Next(&h->cur) ? 1 : 0;
}

int cxio_kind(void* hv) { return static_cast<Handle*>(hv)->cur.kind; }

void cxio_shape(void* hv, int* hh, int* ww, int* cc) {
  auto* h = static_cast<Handle*>(hv);
  *hh = h->cur.h;
  *ww = h->cur.w;
  *cc = h->cur.c;
}

long cxio_size(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  return h->cur.kind ? static_cast<long>(h->cur.pixels.size())
                     : static_cast<long>(h->cur.blob.size());
}

long cxio_copy(void* hv, unsigned char* out, long cap) {
  auto* h = static_cast<Handle*>(hv);
  const auto& src = h->cur.kind ? h->cur.pixels : h->cur.blob;
  long n = static_cast<long>(src.size());
  if (n > cap) return -1;
  std::memcpy(out, src.data(), n);
  return n;
}

void cxio_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  delete h->pipe;
  delete h;
}

}  // extern "C"
