// The C entry convention of the kernel libraries, included by every source.
//
// Each csrc/*.cu builds into a shared library of its own, and every launch
// or query it exports has one signature:
//   extern "C" int gwt_<name>(const long long* d, void* stream)
// d is the call's int64 descriptor: sizes, flags and pointers (0 for an
// absent one) in the order the entry's comment lists, read front to back
// with Desc. stream is the cudaStream_t to launch on. The result is a
// cudaError_t code, 0 on success; gwt_error_string names it. The host side
// of the convention is ops/cuda/build.py's launch().

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace gwt {

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

// A descriptor read in order. An int field outside int's range clears ok().
class Desc {
 public:
  explicit Desc(const long long* d) : d_(d) {}
  long long i64() { return *d_++; }
  int i32() {
    const long long v = *d_++;
    ok_ = ok_ && v >= INT_MIN && v <= INT_MAX;
    return static_cast<int>(v);
  }
  template <class T>
  T* ptr() {
    return reinterpret_cast<T*>(*d_++);
  }
  bool ok() const { return ok_; }

 private:
  const long long* d_;
  bool ok_ = true;
};

}  // namespace gwt

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
