// azrecord: the port's host library for the data path — a multithreaded
// reader over sharded .azr record files (written by
// analytics_zoo_tpu_torch.data.records) and, where libjpeg's header is
// present at build time, libjpeg decode to BGR and encode from BGR.  A C
// ABI consumed through ctypes (analytics_zoo_tpu_torch/data/native.py),
// built with g++ at first use into analytics_zoo_tpu_torch/_build/.
//
// Built without jpeglib.h (AZ_WITH_JPEG undefined), the library holds the
// record reader only and az_has_jpeg() returns 0; the Python side then
// raises when asked for the libjpeg codec, and never falls back.
//
// Threading model: N reader threads each own a disjoint subset of the
// shard files (round-robin by index, matching shard_paths' host sharding)
// and push length-prefixed payloads into one bounded MPMC queue; the
// Python side pops from a single consumer.  Payload buffers are malloc'd
// and ownership passes to the consumer (az_buffer_free).

#include <cstddef>
#include <cstdio>

#if AZ_WITH_JPEG
#include <jpeglib.h>
#endif

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[4] = {'A', 'Z', 'R', '1'};

struct Payload {
  uint8_t* data;
  long len;
};

class BoundedQueue {
 public:
  explicit BoundedQueue(size_t capacity) : capacity_(capacity) {}

  void push(Payload p) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < capacity_ || closed_; });
    if (closed_) {
      free(p.data);
      return;
    }
    q_.push_back(p);
    not_empty_.notify_one();
  }

  // Returns false when the queue is drained AND all producers finished.
  bool pop(Payload* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || producers_ == 0 || closed_; });
    if (closed_ || (q_.empty() && producers_ == 0)) return false;
    *out = q_.front();
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void add_producer() {
    std::lock_guard<std::mutex> lk(mu_);
    ++producers_;
  }

  void done_producer() {
    std::lock_guard<std::mutex> lk(mu_);
    if (--producers_ == 0) not_empty_.notify_all();
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    for (auto& p : q_) free(p.data);
    q_.clear();
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Payload> q_;
  size_t capacity_;
  int producers_ = 0;
  bool closed_ = false;
};

struct Reader {
  BoundedQueue queue;
  std::vector<std::thread> threads;
  std::atomic<bool> cancelled{false};
  explicit Reader(size_t cap) : queue(cap) {}
};

// Read every record of one shard file, pushing payloads into the queue.
// Truncated/corrupt files stop quietly at the damage point (the Python
// layer surfaces counts; a bad shard must not kill the epoch — the same
// contract as the vision pipeline's isValid flow).  The cancellation flag
// is checked per record so close() never waits for a full dataset scan.
void read_file(const std::string& path, BoundedQueue* q,
               const std::atomic<bool>* cancelled) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return;
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, kMagic, 4) != 0) {
    fclose(f);
    return;
  }
  for (;;) {
    if (cancelled->load(std::memory_order_relaxed)) break;
    uint32_t len;
    if (fread(&len, 4, 1, f) != 1) break;
    uint8_t* buf = static_cast<uint8_t*>(malloc(len));
    if (!buf) break;
    if (fread(buf, 1, len, f) != len) {
      free(buf);
      break;
    }
    q->push({buf, static_cast<long>(len)});
  }
  fclose(f);
}

void reader_thread(std::vector<std::string> paths, BoundedQueue* q,
                   const std::atomic<bool>* cancelled) {
  for (const auto& p : paths) {
    if (cancelled->load(std::memory_order_relaxed)) break;
    read_file(p, q, cancelled);
  }
  q->done_producer();
}

#if AZ_WITH_JPEG
// libjpeg error handling: longjmp out instead of exit().
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}
#endif  // AZ_WITH_JPEG

}  // namespace

extern "C" {

void* az_reader_open(const char** paths, int n_paths, int n_threads,
                     int queue_capacity) {
  if (n_paths <= 0) return nullptr;
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n_paths) n_threads = n_paths;
  if (queue_capacity <= 0) queue_capacity = 64;
  Reader* r = new Reader(static_cast<size_t>(queue_capacity));
  std::vector<std::vector<std::string>> buckets(n_threads);
  for (int i = 0; i < n_paths; ++i) buckets[i % n_threads].push_back(paths[i]);
  for (int t = 0; t < n_threads; ++t) r->queue.add_producer();
  for (int t = 0; t < n_threads; ++t) {
    r->threads.emplace_back(reader_thread, buckets[t], &r->queue,
                            &r->cancelled);
  }
  return r;
}

// Returns payload length and sets *out (caller frees with az_buffer_free);
// returns -1 at end of stream.
long az_reader_next(void* handle, uint8_t** out) {
  Reader* r = static_cast<Reader*>(handle);
  Payload p;
  if (!r->queue.pop(&p)) return -1;
  *out = p.data;
  return p.len;
}

void az_buffer_free(uint8_t* buf) { free(buf); }

void az_reader_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  r->cancelled.store(true);
  r->queue.close();
  for (auto& t : r->threads) t.join();
  delete r;
}

int az_has_jpeg() { return AZ_WITH_JPEG ? 1 : 0; }

#if AZ_WITH_JPEG
// Decode JPEG bytes to packed BGR uint8 (OpenCV channel order, matching
// the vision pipeline).  Returns 0 on success; *out is malloc'd.
int az_decode_jpeg(const uint8_t* data, long len, uint8_t** out, int* width,
                   int* height, int* channels) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  uint8_t* buf = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int c = cinfo.output_components;
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(w) * h * c));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *width = w;
  *height = h;
  *channels = c;
  return 0;
}

// Encode packed BGR uint8 (h, w, 3) to baseline JPEG at ``quality`` with
// libjpeg's defaults (4:2:0 chroma, the islow DCT, standard Huffman
// tables) — what cv2.imencode(".jpg") writes.  Returns 0 on success;
// *out is malloc'd (free with az_buffer_free).
int az_encode_jpeg(const uint8_t* bgr, int width, int height, int quality,
                   uint8_t** out, long* len) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_EXT_BGR;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        bgr + static_cast<size_t>(cinfo.next_scanline) * width * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  *len = static_cast<long>(size);
  return 0;
}
#endif  // AZ_WITH_JPEG

long az_count_records(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, kMagic, 4) != 0) {
    fclose(f);
    return -1;
  }
  long count = 0;
  for (;;) {
    uint32_t len;
    if (fread(&len, 4, 1, f) != 1) break;
    if (fseek(f, len, SEEK_CUR) != 0) break;
    ++count;
  }
  fclose(f);
  return count;
}

}  // extern "C"
