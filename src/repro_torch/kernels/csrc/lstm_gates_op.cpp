// K1's launch path as PyTorch operators: repro_torch::lstm_gates_fwd and
// repro_torch::lstm_gates_bwd, the kernels of lstm_gates.cu behind one
// call from Python each.
//
// A ctypes launch from Python paid for two torch.empty calls, a Stream
// object, the argument conversions and the validation in Python: more
// host time a call than aten::_thnn_fused_lstm_cell takes (PERF.md).
// Here the validation, the two output allocations and the launch are C++
// behind one dispatcher call. The validation makes the refusals of the
// Python wrapper's _check for tensors on CUDA, in its order and with its
// exception types (TORCH_CHECK_VALUE raises ValueError, TORCH_CHECK_TYPE
// TypeError); the Python wrapper sends every call that is not all on CUDA
// to _check. The caller passes its current stream's handle.
//
// Built by src/repro_torch/kernels/build.py against torch's headers and
// libraries (its C++ ABI flag), linked with lstm_gates.cu into one shared
// library, and loaded with torch.ops.load_library.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <torch/library.h>

#include <tuple>

extern "C" int lstm_gates_fwd(int dtype, const void* gates, const void* c, void* h_out,
                              void* c_out, int N, int H, void* stream);
extern "C" int lstm_gates_bwd(int dtype, const void* gates, const void* c, const void* dh,
                              const void* dc_next, void* dgates, void* dc_prev, int N, int H,
                              void* stream);

namespace {

void check_rows(const at::Tensor& t, const char* name, int64_t N, int64_t H) {
  TORCH_CHECK_VALUE(t.dim() == 2 && t.size(0) == N && t.size(1) == H, name, " must be (", N,
                    ", ", H, "), got ", t.sizes());
}

// The refusals of lstm_gates.py's _check, in its order, for tensors on
// CUDA; returns the kernel's dtype code (0 float32, 1 bfloat16 gates).
// Keep the two in step: chip_smoke.py's _k1_refusals holds them equal on
// the card, case by case (the same exception type for each input).
int check(const at::Tensor& gates, const at::Tensor& c, const at::Tensor* dh,
          const at::Tensor* dc_next) {
  TORCH_CHECK_VALUE(gates.dim() == 2 && gates.size(1) % 4 == 0, "gates must be (N, 4H), got ",
                    gates.sizes());
  const int64_t N = gates.size(0), H = gates.size(1) / 4;
  check_rows(c, "c", N, H);
  if (dh != nullptr) check_rows(*dh, "dh", N, H);
  if (dc_next != nullptr) check_rows(*dc_next, "dc_next", N, H);
  const bool one_device = c.device() == gates.device() &&
                          (dh == nullptr || dh->device() == gates.device()) &&
                          (dc_next == nullptr || dc_next->device() == gates.device());
  TORCH_CHECK_VALUE(one_device, "gate tensors lie on several devices");
  const auto dtype = gates.scalar_type();
  TORCH_CHECK_TYPE(dtype == at::kFloat || dtype == at::kBFloat16,
                   "the kernel takes float32 or bfloat16 gates, got ", dtype);
  TORCH_CHECK_TYPE(c.scalar_type() == at::kFloat &&
                       (dc_next == nullptr || dc_next->scalar_type() == at::kFloat),
                   "the kernel keeps the cell state in float32");
  TORCH_CHECK_TYPE(dh == nullptr || dh->scalar_type() == dtype, "dh must have the gate dtype ",
                   dtype, ", got ", dh == nullptr ? dtype : dh->scalar_type());
  TORCH_CHECK_VALUE(gates.is_contiguous() && c.is_contiguous() &&
                        (dh == nullptr || dh->is_contiguous()) &&
                        (dc_next == nullptr || dc_next->is_contiguous()),
                    "the kernel takes contiguous tensors");
  TORCH_CHECK_VALUE(N * H > 0 && N * H < (int64_t{1} << 31), "N*H = ", N * H,
                    " is outside the kernel's range [1, 2**31)");
  return dtype == at::kBFloat16 ? 1 : 0;
}

std::tuple<at::Tensor, at::Tensor> fwd(const at::Tensor& gates, const at::Tensor& c,
                                       int64_t stream) {
  const int dtype = check(gates, c, nullptr, nullptr);
  const int N = static_cast<int>(c.size(0)), H = static_cast<int>(c.size(1));
  at::Tensor h = at::empty({N, H}, gates.options());
  at::Tensor c_new = at::empty_like(c);
  const int err = lstm_gates_fwd(dtype, gates.data_ptr(), c.data_ptr(), h.data_ptr(),
                                 c_new.data_ptr(), N, H, reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "lstm_gates_fwd launch failed: cudaError ", err);
  return {h, c_new};
}

std::tuple<at::Tensor, at::Tensor> bwd(const at::Tensor& gates, const at::Tensor& c,
                                       const at::Tensor& dh, const at::Tensor& dc_next,
                                       int64_t stream) {
  const int dtype = check(gates, c, &dh, &dc_next);
  const int N = static_cast<int>(c.size(0)), H = static_cast<int>(c.size(1));
  at::Tensor dgates = at::empty_like(gates);
  at::Tensor dc_prev = at::empty_like(c);
  const int err = lstm_gates_bwd(dtype, gates.data_ptr(), c.data_ptr(), dh.data_ptr(),
                                 dc_next.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(), N, H,
                                 reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "lstm_gates_bwd launch failed: cudaError ", err);
  return {dgates, dc_prev};
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("lstm_gates_fwd(Tensor gates, Tensor c, int stream) -> (Tensor, Tensor)");
  m.def(
      "lstm_gates_bwd(Tensor gates, Tensor c, Tensor dh, Tensor dc_next, int stream) -> "
      "(Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("lstm_gates_fwd", &fwd);
  m.impl("lstm_gates_bwd", &bwd);
}
