// PyTorch operator vdb::csr_ip(Tensor idx, Tensor val, Tensor offs, Tensor q,
// bool shared) -> Tensor for CUDA tensors: the inner product of the query
// scatter q with every row of the CSR column (idx, val, offs), launched by
// csrc/csr_ip.cu; `shared` picks the variant that keeps q in shared memory.
//
// It does in C++ what ops/sparse.py's plain route checks in Python, with
// the same errors (TypeError for a dtype, ValueError for the rest), and
// allocates the output, so a call costs the host what a gather does.

#include <cstdint>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" int vdb_csr_ip(const int32_t* idx, const float* val,
                          const int64_t* offs, const float* q, float* out,
                          long long nnz, long long n_rows, long long len_q,
                          int shared, void* stream);

namespace {

at::Tensor csr_ip(const at::Tensor& idx, const at::Tensor& val,
                  const at::Tensor& offs, const at::Tensor& q, bool shared) {
  TORCH_CHECK_TYPE(idx.scalar_type() == at::kInt,
                   "csr_ip: idx must be int32, got ", idx.scalar_type());
  TORCH_CHECK_TYPE(val.scalar_type() == at::kFloat,
                   "csr_ip: val must be float32, got ", val.scalar_type());
  TORCH_CHECK_TYPE(offs.scalar_type() == at::kLong,
                   "csr_ip: offs must be int64, got ", offs.scalar_type());
  TORCH_CHECK_TYPE(q.scalar_type() == at::kFloat,
                   "csr_ip: q must be float32, got ", q.scalar_type());
  TORCH_CHECK_VALUE(idx.dim() == 1 && val.dim() == 1 && offs.dim() == 1 &&
                        q.dim() == 1,
                    "csr_ip: idx, val, offs and q must be 1-D");
  TORCH_CHECK_VALUE(idx.numel() == val.numel(), "csr_ip: ", idx.numel(),
                    " indices but ", val.numel(), " values");
  TORCH_CHECK_VALUE(offs.numel() >= 1 && q.numel() >= 1,
                    "csr_ip: offs and q must not be empty");
  TORCH_CHECK_VALUE(idx.is_contiguous() && val.is_contiguous() &&
                        offs.is_contiguous() && q.is_contiguous(),
                    "csr_ip: idx, val, offs and q must be contiguous");
  TORCH_CHECK_VALUE(val.device() == idx.device() &&
                        offs.device() == idx.device() &&
                        q.device() == idx.device(),
                    "csr_ip: idx on ", idx.device(), ", val on ",
                    val.device(), ", offs on ", offs.device(), ", q on ",
                    q.device());
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(idx.const_data_ptr()) |
      reinterpret_cast<uintptr_t>(val.const_data_ptr());
  TORCH_CHECK_VALUE(align % 16 == 0,
                    "csr_ip: idx and val must be 16-byte aligned");
  TORCH_CHECK_VALUE(q.numel() <= INT32_MAX, "csr_ip: q has ", q.numel(),
                    " elements, more than the int32 indices can reach");
  const c10::cuda::CUDAGuard guard(idx.device());
  const int64_t n_rows = offs.numel() - 1;
  at::Tensor out = at::empty({n_rows}, val.options());
  if (n_rows == 0) return out;
  const int rc = vdb_csr_ip(
      idx.const_data_ptr<int32_t>(), val.const_data_ptr<float>(),
      offs.const_data_ptr<int64_t>(), q.const_data_ptr<float>(),
      out.mutable_data_ptr<float>(), idx.numel(), n_rows, q.numel(),
      shared ? 1 : 0,
      c10::cuda::getCurrentCUDAStream(idx.device().index()).stream());
  TORCH_CHECK(rc == 0, "csr_ip kernel launch failed: CUDA error ", rc, " (",
              cudaGetErrorString(static_cast<cudaError_t>(rc)), ")");
  return out;
}

}  // namespace

// The vdb namespace is defined by gather_rows_op.cpp (TORCH_LIBRARY); this
// library adds to it, in whichever order the two are loaded.
TORCH_LIBRARY_FRAGMENT(vdb, m) {
  m.def("csr_ip(Tensor idx, Tensor val, Tensor offs, Tensor q, bool shared)"
        " -> Tensor");
}

TORCH_LIBRARY_IMPL(vdb, CUDA, m) { m.impl("csr_ip", &csr_ip); }
