// PyTorch operator vdb::gather_rows(Tensor table, Tensor ids) -> Tensor for
// CUDA tensors: table[clamp(ids, 0, N - 1)] of shape ids.shape +
// table.shape[1:], launched by csrc/gather_rows.cu.
//
// It does in C++ the work a Python wrapper around the C entry point would
// do on every call (checks, output allocation, device and stream lookup,
// the launch), so a small gather, the traversal's usual one, costs the
// host less than index_select does. The checks raise what ops/gather.py's plain route
// raises: TypeError for ids that are not int32, ValueError for the rest.

#include <cstdint>
#include <vector>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" int vdb_gather_rows(const void* tab, const int32_t* ids, void* out,
                               long long n_ids, long long n_rows,
                               long long row_bytes, void* stream);

namespace {

at::Tensor gather_rows(const at::Tensor& table, const at::Tensor& ids) {
  TORCH_CHECK_TYPE(ids.scalar_type() == at::kInt,
                   "gather_rows: ids must be int32, got ", ids.scalar_type());
  TORCH_CHECK_VALUE(table.dim() >= 1 && table.size(0) > 0,
                    "gather_rows: table must have at least one row");
  TORCH_CHECK_VALUE(table.is_contiguous(),
                    "gather_rows: table must be contiguous");
  const int64_t n_rows = table.size(0);
  const int64_t row_bytes = table.numel() / n_rows * table.element_size();
  TORCH_CHECK_VALUE(row_bytes > 0 && row_bytes % 4 == 0,
                    "gather_rows: a table row must be a positive multiple of "
                    "4 bytes, got ", row_bytes);
  TORCH_CHECK_VALUE(ids.device() == table.device(), "gather_rows: ids on ",
                    ids.device(), ", table on ", table.device());
  const c10::cuda::CUDAGuard guard(table.device());
  const at::Tensor idc = ids.contiguous();
  std::vector<int64_t> shape(ids.sizes().begin(), ids.sizes().end());
  shape.insert(shape.end(), table.sizes().begin() + 1, table.sizes().end());
  at::Tensor out = at::empty(shape, table.options());
  if (idc.numel() == 0) return out;
  const int rc = vdb_gather_rows(
      table.const_data_ptr(), idc.const_data_ptr<int32_t>(),
      out.mutable_data_ptr(), idc.numel(), n_rows, row_bytes,
      c10::cuda::getCurrentCUDAStream(table.device().index()).stream());
  TORCH_CHECK(rc == 0, "gather_rows kernel launch failed: CUDA error ", rc,
              " (", cudaGetErrorString(static_cast<cudaError_t>(rc)), ")");
  return out;
}

}  // namespace

TORCH_LIBRARY(vdb, m) {
  m.def("gather_rows(Tensor table, Tensor ids) -> Tensor");
}

TORCH_LIBRARY_IMPL(vdb, CUDA, m) { m.impl("gather_rows", &gather_rows); }
