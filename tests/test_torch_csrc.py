"""The port's CUDA sources, read by a host C++ compiler where no CUDA
compiler is: each ``csrc/*.cu`` goes through ``g++ -fsyntax-only`` with a
small header that declares what CUDA provides (qualifiers, thread indices,
vector types, the intrinsics the kernels use) and with the ``<<<...>>>``
launch configurations removed. It catches typos, undeclared names and type
errors before a run on the card; it does not compile device code. Skips
where no g++ is installed."""
import pathlib
import re
import shutil
import subprocess

import pytest

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "gsplat_tpu_torch"
        / "ops" / "kernels" / "csrc")
SHIM = """
#pragma once
#include <algorithm>
#include <cmath>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
cudaError_t cudaGetLastError();
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __fsub_rn(float, float);
float __fdiv_rn(float, float);
float __shfl_xor_sync(unsigned, float, int);
float __shfl_up_sync(unsigned, float, unsigned, int);
float __shfl_sync(unsigned, float, int, int);
int __any_sync(unsigned, int);
int __reduce_max_sync(unsigned, int);
void __syncthreads();
int __syncthreads_count(int);
"""


@pytest.mark.parametrize("name", sorted(p.stem for p in CSRC.glob("*.cu")))
def test_cuda_source_parses(name, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to read the CUDA sources with")
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    src = re.sub(r"<<<.*?>>>", "", (CSRC / f"{name}.cu").read_text(),
                 flags=re.S)
    host = tmp_path / f"{name}.cpp"
    host.write_text(src)
    out = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
         "-I", str(tmp_path), "-I", str(CSRC), str(host)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
