// PyTorch operator vdb::beam_iter for CUDA tensors: iterations [it_begin,
// it_end) of the beam traversal, launched by csrc/beam_iter.cu with kernel
// `variant` (0: a block a query, 1: a warp a query), updating the state
// (beam_ids, beam_exp, beam_d, visited, flags) in place. A batch that walks
// more than one iteration is one cooperative launch; the card refuses it
// (a RuntimeError naming the CUDA error) when the batch is not resident.
//
// It does in C++ what ops/beam.py's plain route checks in Python, with the
// same errors (TypeError for a dtype, ValueError for the rest), so a launch
// costs the host what a gather does.

#include <cstdint>
#include <initializer_list>
#include <optional>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" int vdb_beam_iter(const void* q, const float* q_norms,
                             const void* table, const int32_t* adj,
                             const int8_t* fused, float scale,
                             int32_t* beam_ids, uint8_t* beam_exp,
                             float* beam_d, int32_t* visited, int32_t* flags,
                             long long n_table, long long n_adj,
                             long long n_fused, int b, int d, int l, int m,
                             int r, int v, int cp, int tw, int metric,
                             int it_begin, int it_end, int peel, int n_flags,
                             int bf16, void* scratch, void* stream,
                             int variant, int32_t* done);
extern "C" long long vdb_beam_iter_scratch(int l, int d, int m, int r);
extern "C" int vdb_beam_iter_takes(int variant, int bf16, int fused, int l,
                                   int d, int m, int r, int v);

namespace {

void beam_iter(const at::Tensor& q, const at::Tensor& q_norms,
               const at::Tensor& table, const at::Tensor& adjacency,
               const std::optional<at::Tensor>& fused, double scale,
               at::Tensor& beam_ids, at::Tensor& beam_exp, at::Tensor& beam_d,
               at::Tensor& visited, at::Tensor& flags, int64_t expand,
               int64_t metric, int64_t it_begin, int64_t it_end, int64_t cp,
               int64_t tw, bool peel, int64_t variant) {
  const bool bf16 = table.scalar_type() == at::kBFloat16;
  TORCH_CHECK_TYPE(bf16 || table.scalar_type() == at::kFloat,
                   "beam_iter: table must be bfloat16 or float32, got ",
                   table.scalar_type());
  TORCH_CHECK_TYPE(q.scalar_type() == table.scalar_type(),
                   "beam_iter: q must have the table's dtype ",
                   table.scalar_type(), ", got ", q.scalar_type());
  TORCH_CHECK_TYPE(q_norms.scalar_type() == at::kFloat &&
                       beam_d.scalar_type() == at::kFloat,
                   "beam_iter: q_norms and beam_d must be float32");
  TORCH_CHECK_TYPE(adjacency.scalar_type() == at::kInt &&
                       beam_ids.scalar_type() == at::kInt &&
                       visited.scalar_type() == at::kInt &&
                       flags.scalar_type() == at::kInt,
                   "beam_iter: adjacency, beam_ids, visited and flags must "
                   "be int32");
  TORCH_CHECK_TYPE(beam_exp.scalar_type() == at::kBool,
                   "beam_iter: beam_exp must be bool, got ",
                   beam_exp.scalar_type());
  TORCH_CHECK_VALUE(q.dim() == 2 && table.dim() == 2 && adjacency.dim() == 2 &&
                        beam_ids.dim() == 2 && q_norms.dim() == 1 &&
                        flags.dim() == 1,
                    "beam_iter: wrong ranks");
  const int64_t b = q.size(0), d = q.size(1), n = table.size(0);
  const int64_t l = beam_ids.size(1), r = adjacency.size(1);
  TORCH_CHECK_VALUE(b >= 1 && n >= 1 && table.size(1) == d &&
                        adjacency.size(0) >= 1 && q_norms.size(0) == b &&
                        beam_ids.size(0) == b && beam_exp.sizes() ==
                        beam_ids.sizes() && beam_d.sizes() == beam_ids.sizes()
                        && visited.dim() == 2 && visited.size(0) == b,
                    "beam_iter: shapes disagree");
  TORCH_CHECK_VALUE(d % 16 == 0, "beam_iter: the row width ", d,
                    " must be a multiple of 16");
  TORCH_CHECK_VALUE(expand >= 1 && l >= expand && r >= 1 &&
                        expand * r <= 4096,
                    "beam_iter: needs 1 <= expand <= L and expand * R <= "
                    "4096, got expand ", expand, ", L ", l, ", R ", r);
  TORCH_CHECK_VALUE(0 <= it_begin && it_begin <= it_end &&
                        it_end * expand <= visited.size(1) &&
                        it_end <= flags.size(0),
                    "beam_iter: iterations [", it_begin, ", ", it_end,
                    ") do not fit visited or flags");
  TORCH_CHECK_VALUE(0 <= tw && tw <= l, "beam_iter: tw ", tw,
                    " outside [0, L]");
  const int8_t* fz = nullptr;
  int64_t n_fused = 0;
  if (fused.has_value()) {
    const at::Tensor& f = *fused;
    TORCH_CHECK_TYPE(f.scalar_type() == at::kChar,
                     "beam_iter: fused must be int8, got ", f.scalar_type());
    TORCH_CHECK_VALUE(f.dim() == 2 && f.size(0) >= 1 && f.size(1) == r * d &&
                          f.is_contiguous() && f.device() == table.device(),
                      "beam_iter: fused must be a contiguous [N, R * D] "
                      "tensor on the table's device");
    fz = f.const_data_ptr<int8_t>();
    n_fused = f.size(0);
  }
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{
           &q, &q_norms, &table, &adjacency, &beam_ids, &beam_exp, &beam_d,
           &visited, &flags}) {
    TORCH_CHECK_VALUE(t->is_contiguous(),
                      "beam_iter: every tensor must be contiguous");
    TORCH_CHECK_VALUE(t->device() == table.device(), "beam_iter: a tensor on ",
                      t->device(), ", the table on ", table.device());
  }
  TORCH_CHECK_VALUE(
      vdb_beam_iter_takes((int)variant, bf16 ? 1 : 0, fz ? 1 : 0, (int)l,
                          (int)d, (int)expand, (int)r,
                          (int)visited.size(1)) != 0,
      "beam_iter: kernel variant ", variant, " does not take L ", l, ", D ",
      d, ", expand ", expand, ", R ", r, ", visited ", visited.size(1));
  const c10::cuda::CUDAGuard guard(table.device());
  // The block variant double-buffers a beam too wide for shared memory in
  // global memory: the state and this scratch copy.
  const long long per_query =
      variant == 0 ? vdb_beam_iter_scratch((int)l, (int)d, (int)expand,
                                           (int)r)
                   : 0;
  TORCH_CHECK(per_query >= 0, "beam_iter: CUDA error ", -per_query,
              " reading the device's shared memory limit");
  at::Tensor scratch;
  if (per_query > 0) {
    scratch = at::empty({b * per_query}, table.options().dtype(at::kByte));
  }
  // The warp variant's walk of a batch counts its queries done with each
  // iteration.
  at::Tensor done;
  if (variant == 1 && b > 1 && it_end > it_begin + 1) {
    done = at::zeros({it_end - it_begin}, flags.options());
  }
  const int rc = vdb_beam_iter(
      q.const_data_ptr(), q_norms.const_data_ptr<float>(),
      table.const_data_ptr(), adjacency.const_data_ptr<int32_t>(), fz,
      static_cast<float>(scale), beam_ids.mutable_data_ptr<int32_t>(),
      reinterpret_cast<uint8_t*>(beam_exp.mutable_data_ptr<bool>()),
      beam_d.mutable_data_ptr<float>(), visited.mutable_data_ptr<int32_t>(),
      flags.mutable_data_ptr<int32_t>(), n, adjacency.size(0), n_fused,
      (int)b, (int)d, (int)l, (int)expand, (int)r, (int)visited.size(1), (int)cp, (int)tw,
      (int)metric, (int)it_begin, (int)it_end, peel ? 1 : 0,
      (int)flags.size(0), bf16 ? 1 : 0,
      per_query > 0 ? scratch.mutable_data_ptr() : nullptr,
      c10::cuda::getCurrentCUDAStream(table.device().index()).stream(),
      (int)variant, done.defined() ? done.mutable_data_ptr<int32_t>() : nullptr);
  TORCH_CHECK(rc == 0, "beam_iter kernel launch failed: CUDA error ", rc, " (",
              cudaGetErrorString(static_cast<cudaError_t>(rc)), ")");
}

}  // namespace

// The vdb namespace is defined by gather_rows_op.cpp (TORCH_LIBRARY); this
// library adds to it, in whichever order they are loaded.
TORCH_LIBRARY_FRAGMENT(vdb, m) {
  m.def("beam_iter(Tensor q, Tensor q_norms, Tensor table, Tensor adjacency, "
        "Tensor? fused, float scale, Tensor(a!) beam_ids, "
        "Tensor(b!) beam_exp, Tensor(c!) beam_d, Tensor(d!) visited, "
        "Tensor(e!) flags, int expand, int metric, int it_begin, int it_end, "
        "int cp, int tw, bool peel, int variant=0) -> ()");
}

TORCH_LIBRARY_IMPL(vdb, CUDA, m) { m.impl("beam_iter", &beam_iter); }
