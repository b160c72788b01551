// Core types for the native horovod_tpu runtime.
//
// TPU-native re-design of the reference's type layer (reference
// horovod/common/common.h:28-110: Status, StatusType, TensorShape, DataType)
// plus the fp16/bf16 software conversion (reference horovod/common/half.h:37-131).
// No MPI, no CUDA: the native runtime is the host-side eager engine; the
// compiled data plane lives in XLA.
#ifndef HVD_COMMON_H
#define HVD_COMMON_H

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace hvd {

// Allocator whose default-construct is a no-op: Buffer::resize() leaves
// the bytes uninitialized instead of zero-filling them. Payload buffers
// are written in full by the collective that produces them (allgather
// slots, reduce folds, memcpy-out), so the value-initializing resize of
// a plain std::vector was a wasted full write of every payload — real
// memory traffic at 100 MB gradients × 16 ranks on one host.
template <typename T, typename A = std::allocator<T>>
class default_init_allocator : public A {
  using a_t = std::allocator_traits<A>;

 public:
  template <typename U>
  struct rebind {
    using other = default_init_allocator<
        U, typename a_t::template rebind_alloc<U>>;
  };
  using A::A;
  template <typename U>
  void construct(U* ptr) noexcept(
      std::is_nothrow_default_constructible<U>::value) {
    ::new (static_cast<void*>(ptr)) U;
  }
  template <typename U, typename... Args>
  void construct(U* ptr, Args&&... args) {
    a_t::construct(static_cast<A&>(*this), ptr,
                   std::forward<Args>(args)...);
  }
};

// Payload byte buffer (tensor-sized): uninitialized on resize.
using Buffer = std::vector<uint8_t, default_init_allocator<uint8_t>>;

enum class StatusType : int {
  OK = 0,
  UNKNOWN_ERROR = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

struct Status {
  StatusType type = StatusType::OK;
  std::string reason;

  static Status OK_() { return Status{}; }
  static Status Unknown(std::string msg) {
    return Status{StatusType::UNKNOWN_ERROR, std::move(msg)};
  }
  static Status Precondition(std::string msg) {
    return Status{StatusType::PRECONDITION_ERROR, std::move(msg)};
  }
  static Status Aborted(std::string msg) {
    return Status{StatusType::ABORTED, std::move(msg)};
  }
  static Status InvalidArgument(std::string msg) {
    return Status{StatusType::INVALID_ARGUMENT, std::move(msg)};
  }
  bool ok() const { return type == StatusType::OK; }
};

// Order must stay in sync with horovod_tpu/cc/native_engine.py DTYPES.
enum class DataType : uint8_t {
  U8 = 0,
  I8 = 1,
  I32 = 2,
  I64 = 3,
  F16 = 4,
  BF16 = 5,
  F32 = 6,
  F64 = 7,
  BOOL = 8,
};

inline size_t dtype_size(DataType t) {
  switch (t) {
    case DataType::U8:
    case DataType::I8:
    case DataType::BOOL:
      return 1;
    case DataType::F16:
    case DataType::BF16:
      return 2;
    case DataType::I32:
    case DataType::F32:
      return 4;
    case DataType::I64:
    case DataType::F64:
      return 8;
  }
  return 1;
}

// Collective op ids (order in sync with native_engine.py OPS).
enum class OpType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  REDUCESCATTER = 3,
  ALLTOALL = 4,
};

inline const char* op_name(OpType op) {
  switch (op) {
    case OpType::ALLREDUCE: return "ALLREDUCE";
    case OpType::ALLGATHER: return "ALLGATHER";
    case OpType::BROADCAST: return "BROADCAST";
    case OpType::REDUCESCATTER: return "REDUCESCATTER";
    case OpType::ALLTOALL: return "ALLTOALL";
  }
  return "?";
}

// fp16 <-> fp32 bit conversion (software, no F16C dependency; same math as
// the reference's HalfBits2Float/Float2HalfBits, horovod/common/half.h:37-131,
// re-derived from the IEEE-754 layouts).
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // zero
    } else {        // subnormal: normalize
      int e = -1;
      uint32_t m = mant;
      while (!(m & 0x400)) {
        m <<= 1;
        e++;
      }
      m &= 0x3ff;
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (m << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000 | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t float_to_half(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint16_t sign = (uint16_t)((bits >> 16) & 0x8000);
  int32_t exp = (int32_t)((bits >> 23) & 0xff) - 127 + 15;
  uint32_t mant = bits & 0x7fffff;
  if (((bits >> 23) & 0xff) == 0xff) {               // inf/nan
    return (uint16_t)(sign | 0x7c00 | (mant ? 0x200 : 0));
  }
  if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00);  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return sign;  // underflow -> zero
    mant |= 0x800000;            // subnormal with round-to-nearest-even
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half_mant = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_mant & 1))) half_mant++;
    return (uint16_t)(sign | half_mant);
  }
  uint32_t half_mant = mant >> 13;
  uint32_t rem = mant & 0x1fff;
  if (rem > 0x1000 || (rem == 0x1000 && (half_mant & 1))) {
    half_mant++;
    if (half_mant == 0x400) {
      half_mant = 0;
      exp++;
      if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00);
    }
  }
  return (uint16_t)(sign | (exp << 10) | half_mant);
}

inline float bf16_to_float(uint16_t b) {
  uint32_t bits = (uint32_t)b << 16;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t float_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if (((bits >> 23) & 0xff) == 0xff) {
    // inf/NaN: rounding could carry through an all-ones mantissa into the
    // sign bit (0x7FFFFFFF + 0x8000 -> -0.0), silently zeroing NaNs in
    // reductions. Preserve the class; quiet the NaN.
    return (uint16_t)((bits >> 16) | ((bits & 0x7fffff) ? 0x40 : 0));
  }
  // round-to-nearest-even on the dropped 16 bits
  uint32_t rounding = 0x7fff + ((bits >> 16) & 1);
  return (uint16_t)((bits + rounding) >> 16);
}

}  // namespace hvd

#endif  // HVD_COMMON_H
