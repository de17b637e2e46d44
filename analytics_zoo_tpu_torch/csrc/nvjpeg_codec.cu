// nvjpeg_codec: JPEG decode to packed BGR and encode from packed BGR on
// the GPU through the CUDA toolkit's nvJPEG, for the port's input path on
// a card whose machine has no libjpeg header (the codec rule in
// analytics_zoo_tpu_torch/data/native.py).  JPEG decode is not a TPU
// kernel: this binds the toolkit's codec, it ports no kernel.
//
// One handle, one decode state and one encoder for the process, made at
// first use on the current device; every call holds one mutex (the
// prefetch thread decodes while the training step runs) and works on its
// own non-blocking stream, so it never waits on the legacy default stream
// the training step's kernels run on.  The device staging buffer grows
// and is kept: a cudaFree would synchronize the whole device.
//
// A corrupt or unsupported JPEG returns 1 (the caller drops the record);
// a failure of the codec itself returns 1000 + a CUDA error or 2000 + the
// nvJPEG call that failed.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>

namespace {

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  int quality = -1;
  int ready = 0;  // 0 = not made, 1 = made, -1 = failed to make
  int error = 0;
};

Codec g;
std::mutex g_mu;

int fail(int code) { return 1000 + code; }      // a CUDA error
int nvj_fail(int step) { return 2000 + step; }  // an nvJPEG call

int make_codec() {
  if (g.ready == 1) return 0;
  if (g.ready == -1) return g.error;
  int rc = 0;
  cudaError_t ce = cudaStreamCreateWithFlags(&g.stream,
                                             cudaStreamNonBlocking);
  if (ce != cudaSuccess) rc = fail(ce);
  if (!rc && nvjpegCreateSimple(&g.handle) != NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(1);
  if (!rc && nvjpegJpegStateCreate(g.handle, &g.state) !=
                 NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(2);
  if (!rc && nvjpegEncoderStateCreate(g.handle, &g.enc_state, g.stream) !=
                 NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(3);
  if (!rc && nvjpegEncoderParamsCreate(g.handle, &g.enc_params, g.stream) !=
                 NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(4);
  // what cv2.imencode(".jpg") writes: baseline, 4:2:0, standard tables
  if (!rc && nvjpegEncoderParamsSetSamplingFactors(
                 g.enc_params, NVJPEG_CSS_420, g.stream) !=
                 NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(5);
  if (!rc && nvjpegEncoderParamsSetOptimizedHuffman(g.enc_params, 0,
                                                    g.stream) !=
                 NVJPEG_STATUS_SUCCESS)
    rc = nvj_fail(6);
  g.ready = rc ? -1 : 1;
  g.error = rc;
  return rc;
}

int reserve(size_t bytes) {
  if (bytes <= g.dev_bytes) return 0;
  if (g.dev) {
    cudaStreamSynchronize(g.stream);
    cudaFree(g.dev);
    g.dev = nullptr;
    g.dev_bytes = 0;
  }
  cudaError_t ce = cudaMalloc(&g.dev, bytes);
  if (ce != cudaSuccess) return fail(ce);
  g.dev_bytes = bytes;
  return 0;
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  if (code == 1) return "not a decodable JPEG";
  if (code >= 2000) return "an nvJPEG call failed (code - 2000 = which)";
  return cudaGetErrorString(static_cast<cudaError_t>(code - 1000));
}

// Make the codec now (the handle, the states, the stream): 0 when it is
// usable.  Callers probe this once, so that a codec that cannot load
// raises before any record is read.
int az_nvjpeg_init() {
  std::lock_guard<std::mutex> lk(g_mu);
  return make_codec();
}

// Width and height of a JPEG's image: 0 on success, 1 when the bytes are
// not a JPEG nvJPEG decodes.
int az_nvjpeg_info(const uint8_t* data, long len, int* width, int* height) {
  std::lock_guard<std::mutex> lk(g_mu);
  int rc = make_codec();
  if (rc) return rc;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g.handle, data, static_cast<size_t>(len), &n_comp,
                         &sub, w, h) != NVJPEG_STATUS_SUCCESS ||
      w[0] <= 0 || h[0] <= 0)
    return 1;
  *width = w[0];
  *height = h[0];
  return 0;
}

// Decode to packed BGR (height, width, 3) uint8 in host memory ``out``
// (the sizes az_nvjpeg_info gave).  0 on success, 1 on a corrupt JPEG.
int az_nvjpeg_decode(const uint8_t* data, long len, uint8_t* out, int width,
                     int height) {
  std::lock_guard<std::mutex> lk(g_mu);
  int rc = make_codec();
  if (rc) return rc;
  const size_t pitch = static_cast<size_t>(width) * 3;
  rc = reserve(pitch * height);
  if (rc) return rc;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = g.dev;
  img.pitch[0] = pitch;
  if (nvjpegDecode(g.handle, g.state, data, static_cast<size_t>(len),
                   NVJPEG_OUTPUT_BGRI, &img, g.stream) !=
      NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(g.stream);
    return 1;
  }
  cudaError_t ce = cudaMemcpyAsync(out, g.dev, pitch * height,
                                   cudaMemcpyDeviceToHost, g.stream);
  if (ce == cudaSuccess) ce = cudaStreamSynchronize(g.stream);
  return ce == cudaSuccess ? 0 : fail(ce);
}

// Encode packed BGR (height, width, 3) uint8 host pixels at ``quality``.
// *out is malloc'd (free with az_nvjpeg_free), *len its bytes.
int az_nvjpeg_encode(const uint8_t* bgr, int width, int height, int quality,
                     uint8_t** out, long* len) {
  std::lock_guard<std::mutex> lk(g_mu);
  int rc = make_codec();
  if (rc) return rc;
  if (quality != g.quality) {
    if (nvjpegEncoderParamsSetQuality(g.enc_params, quality, g.stream) !=
        NVJPEG_STATUS_SUCCESS)
      return nvj_fail(7);
    g.quality = quality;
  }
  const size_t pitch = static_cast<size_t>(width) * 3;
  rc = reserve(pitch * height);
  if (rc) return rc;
  cudaError_t ce = cudaMemcpyAsync(g.dev, bgr, pitch * height,
                                   cudaMemcpyHostToDevice, g.stream);
  if (ce != cudaSuccess) return fail(ce);
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = g.dev;
  img.pitch[0] = pitch;
  if (nvjpegEncodeImage(g.handle, g.enc_state, g.enc_params, &img,
                        NVJPEG_INPUT_BGRI, width, height, g.stream) !=
      NVJPEG_STATUS_SUCCESS)
    return nvj_fail(8);
  size_t n = 0;
  if (nvjpegEncodeRetrieveBitstream(g.handle, g.enc_state, nullptr, &n,
                                    g.stream) != NVJPEG_STATUS_SUCCESS)
    return nvj_fail(9);
  ce = cudaStreamSynchronize(g.stream);
  if (ce != cudaSuccess) return fail(ce);
  uint8_t* buf = static_cast<uint8_t*>(malloc(n));
  if (!buf) return fail(cudaErrorMemoryAllocation);
  if (nvjpegEncodeRetrieveBitstream(g.handle, g.enc_state, buf, &n,
                                    g.stream) != NVJPEG_STATUS_SUCCESS) {
    free(buf);
    return nvj_fail(10);
  }
  ce = cudaStreamSynchronize(g.stream);
  if (ce != cudaSuccess) {
    free(buf);
    return fail(ce);
  }
  *out = buf;
  *len = static_cast<long>(n);
  return 0;
}

void az_nvjpeg_free(uint8_t* buf) { free(buf); }

}  // extern "C"
