// JPEG decode and encode on the card through nvJPEG, behind a plain C
// interface for ctypes (data/nvjpeg_codec.py builds and loads it).
//
// One nvJPEG handle a device for the whole process (default backend: the
// Huffman decode on the host, the IDCT and colour work on the card). A
// "state" bundles what nvJPEG does not let two threads share: a decoder
// state, an encoder state and its parameters; the Python side keeps them in
// a pool for the process and hands each to one thread at a time. nvJPEG's
// device and pinned buffers come from the counting allocators below, so
// their bytes can be reported beside PyTorch's own (which cannot see them).
//
// Every entry point returns 0, an nvjpegStatus_t, or kCudaBase plus a
// cudaError_t. Pointers and the stream travel as void*.

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace {

constexpr int kCudaBase = 1000;
constexpr int kMaxDevices = 64;

std::mutex g_mem_mu;
std::unordered_map<void*, size_t> g_dev_sizes, g_pin_sizes;
long long g_dev_cur = 0, g_dev_peak = 0, g_pin_cur = 0, g_pin_peak = 0;

void count_alloc(std::unordered_map<void*, size_t>& sizes, long long& cur, long long& peak,
                 void* p, size_t n) {
  std::lock_guard<std::mutex> g(g_mem_mu);
  sizes[p] = n;
  cur += static_cast<long long>(n);
  if (cur > peak) peak = cur;
}

void count_free(std::unordered_map<void*, size_t>& sizes, long long& cur, void* p) {
  std::lock_guard<std::mutex> g(g_mem_mu);
  auto it = sizes.find(p);
  if (it != sizes.end()) {
    cur -= static_cast<long long>(it->second);
    sizes.erase(it);
  }
}

int dev_malloc(void** p, size_t n) {
  cudaError_t e = cudaMalloc(p, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  count_alloc(g_dev_sizes, g_dev_cur, g_dev_peak, *p, n);
  return 0;
}

int dev_free(void* p) {
  count_free(g_dev_sizes, g_dev_cur, p);
  return static_cast<int>(cudaFree(p));
}

int pin_malloc(void** p, size_t n, unsigned int flags) {
  cudaError_t e = cudaHostAlloc(p, n, flags);
  if (e != cudaSuccess) return static_cast<int>(e);
  count_alloc(g_pin_sizes, g_pin_cur, g_pin_peak, *p, n);
  return 0;
}

int pin_free(void* p) {
  count_free(g_pin_sizes, g_pin_cur, p);
  return static_cast<int>(cudaFreeHost(p));
}

nvjpegDevAllocator_t g_dev_alloc = {dev_malloc, dev_free};
nvjpegPinnedAllocator_t g_pin_alloc = {pin_malloc, pin_free};

std::mutex g_handle_mu;
nvjpegHandle_t g_handles[kMaxDevices] = {};

struct State {
  int device;
  nvjpegHandle_t handle;
  nvjpegJpegState_t dec;
  nvjpegEncoderState_t enc;
  nvjpegEncoderParams_t params;
};

void release(State* st) {
  if (st->params) nvjpegEncoderParamsDestroy(st->params);
  if (st->enc) nvjpegEncoderStateDestroy(st->enc);
  if (st->dec) nvjpegJpegStateDestroy(st->dec);
  delete st;
}

int set_device(int device) {
  cudaError_t e = cudaSetDevice(device);
  return e == cudaSuccess ? 0 : kCudaBase + static_cast<int>(e);
}

nvjpegImage_t image(void* c0, long long p0, void* c1, long long p1, void* c2, long long p2) {
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(c0);
  img.channel[1] = static_cast<unsigned char*>(c1);
  img.channel[2] = static_cast<unsigned char*>(c2);
  img.pitch[0] = static_cast<size_t>(p0);
  img.pitch[1] = static_cast<size_t>(p1);
  img.pitch[2] = static_cast<size_t>(p2);
  return img;
}

}  // namespace

extern "C" {

// nvJPEG's version as major, minor, patch.
int cd_nvjpeg_version(int* out) {
  int s = nvjpegGetProperty(MAJOR_VERSION, &out[0]);
  if (!s) s = nvjpegGetProperty(MINOR_VERSION, &out[1]);
  if (!s) s = nvjpegGetProperty(PATCH_LEVEL, &out[2]);
  return s;
}

// A new state on `device` (the device's handle made first if it has none).
int cd_nvjpeg_state_create(int device, void** out) {
  if (device < 0 || device >= kMaxDevices) return NVJPEG_STATUS_INVALID_PARAMETER;
  int rc = set_device(device);
  if (rc) return rc;
  nvjpegHandle_t handle;
  {
    std::lock_guard<std::mutex> g(g_handle_mu);
    if (!g_handles[device]) {
      nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, &g_dev_alloc, &g_pin_alloc,
                                        NVJPEG_FLAGS_DEFAULT, &g_handles[device]);
      if (s != NVJPEG_STATUS_SUCCESS) {
        g_handles[device] = nullptr;
        return s;
      }
    }
    handle = g_handles[device];
  }
  State* st = new State{device, handle, nullptr, nullptr, nullptr};
  nvjpegStatus_t s = nvjpegJpegStateCreate(handle, &st->dec);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegEncoderStateCreate(handle, &st->enc, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegEncoderParamsCreate(handle, &st->params, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetSamplingFactors(st->params, NVJPEG_CSS_420, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetEncoding(st->params, NVJPEG_ENCODING_BASELINE_DCT, nullptr);
  if (s != NVJPEG_STATUS_SUCCESS) {
    release(st);
    return s;
  }
  *out = st;
  return 0;
}

// Decode `len` bytes of host memory on `stream`: with rgb == 0 into the
// file's own planes (NVJPEG_OUTPUT_YUV: Y, then Cb and Cr at the file's
// sampling), else into interleaved RGB in c0 (NVJPEG_OUTPUT_RGBI).
int cd_nvjpeg_decode(void* state, const void* data, long long len, int rgb, void* c0,
                     long long p0, void* c1, long long p1, void* c2, long long p2,
                     void* stream) {
  State* st = static_cast<State*>(state);
  int rc = set_device(st->device);
  if (rc) return rc;
  nvjpegImage_t img = image(c0, p0, c1, p1, c2, p2);
  return nvjpegDecode(st->handle, st->dec, static_cast<const unsigned char*>(data),
                      static_cast<size_t>(len), rgb ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_YUV,
                      &img, static_cast<cudaStream_t>(stream));
}

// Encode 4:2:0 planes (Y width x height, Cb and Cr at half each, rounded
// up) as a baseline JPEG at `quality` on `stream`; *out_len gets the
// stream's length in bytes. Waits for the stream (nvJPEG's retrieve does).
int cd_nvjpeg_encode_yuv420(void* state, const void* y, long long py, const void* cb,
                            long long pcb, const void* cr, long long pcr, int width,
                            int height, int quality, void* stream, long long* out_len) {
  State* st = static_cast<State*>(state);
  int rc = set_device(st->device);
  if (rc) return rc;
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t s = nvjpegEncoderParamsSetQuality(st->params, quality, s_);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  nvjpegImage_t img = image(const_cast<void*>(y), py, const_cast<void*>(cb), pcb,
                            const_cast<void*>(cr), pcr);
  s = nvjpegEncodeYUV(st->handle, st->enc, st->params, &img, NVJPEG_CSS_420, width, height, s_);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  size_t n = 0;
  s = nvjpegEncodeRetrieveBitstream(st->handle, st->enc, nullptr, &n, s_);
  *out_len = static_cast<long long>(n);
  return s;
}

// Copy the last encoded stream of `state` into `out` (*len bytes of room;
// *len gets the bytes written).
int cd_nvjpeg_encode_retrieve(void* state, void* out, long long* len, void* stream) {
  State* st = static_cast<State*>(state);
  int rc = set_device(st->device);
  if (rc) return rc;
  size_t n = static_cast<size_t>(*len);
  nvjpegStatus_t s = nvjpegEncodeRetrieveBitstream(
      st->handle, st->enc, static_cast<unsigned char*>(out), &n, static_cast<cudaStream_t>(stream));
  *len = static_cast<long long>(n);
  return s;
}

// nvJPEG's own bytes: device now, device peak, pinned now, pinned peak;
// with reset_peak != 0 the peaks restart from the current bytes.
int cd_nvjpeg_memory(long long* out, int reset_peak) {
  std::lock_guard<std::mutex> g(g_mem_mu);
  if (reset_peak) {
    g_dev_peak = g_dev_cur;
    g_pin_peak = g_pin_cur;
  }
  out[0] = g_dev_cur;
  out[1] = g_dev_peak;
  out[2] = g_pin_cur;
  out[3] = g_pin_peak;
  return 0;
}

}  // extern "C"
