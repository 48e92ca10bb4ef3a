"""The kernels' CUDA sources as host C++, for the tests that build them
with g++ and run them through the port's wrappers on CPU tensors
(tests/test_torch_preprocess_packed.py, tests/test_torch_gather_entries.py).
Each test brings its own ``cuda_runtime.h`` shim, which defines
``host_launch``."""
import re

_LAUNCH = re.compile(r"(\w+)<<<(.*?),(.*?),(.*?),.*?>>>\((.*?)\);", re.S)


def host_source(src: str) -> str:
    """A kernel source as host C++: each launch a ``host_launch`` of its
    grid, its dynamic shared memory the shim's buffer."""
    src = _LAUNCH.sub(r"host_launch(\2, \3, \4, [&]() { \1(\5); });", src)
    return re.sub(r"extern __shared__ float (\w+)\[\];",
                  r"float* \1 = g_smem.data();", src)
