"""The entry gather: the compositor's (M, 16) entry rows from the (N+1, 16)
packed rows, by slot index and depth order. Its plain chain, its CUDA
kernels' wrappers and the ``torch.autograd.Function`` that joins them.

``gather_entries_plain`` is the chain the render path has always taken:
``packed.index_select(0, cat(perm, [N])).index_select(0, gidx_sorted)``,
whose gradient is autograd's two ``index_add_``s. It is the CPU's path
and the oracle both kernels are held to. csrc/gather_entries_fwd.cu does
the forward in one launch: it copies ``packed[perm[g]]`` (or the zero row
N for a dead slot, g = N) into every slot, bit for bit the chain's.
csrc/gather_entries_bwd.cu does the backward in one launch: each
gaussian's row is the sum of its slots' gradient rows, taken by one thread
in the order of the gaussian's pairs, which the binning's slot tables give
(ops/binning.py ``bin_gaussians(slot_tables=True)``). It uses no atomics,
so it gives the same rows on every run; row N's gradient is 0.
ops/rasterize.py ``build_entries`` routes a call to one or the other.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from gsplat_tpu_torch.ops.binning import Binning
from gsplat_tpu_torch.ops.kernels import build

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = {
    # packed, perm, gidx_sorted, N, M, entries, the stream
    "gather_entries_fwd": [_P, _P, _P, _L, _L, _P, _P],
    # d entries, perm, slot_of, g_offsets, g_counts, N, m_cap, M, d packed,
    # the stream
    "gather_entries_bwd": [_P] * 5 + [_L] * 3 + [_P, _P],
}


@functools.lru_cache(maxsize=None)
def _bound(name: str, csrc: Path):
    fn = getattr(build.load(name, csrc), f"gsplat_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _require_cuda(name: str, dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")


def _check(name: str, rows: torch.Tensor, n_rows: int, **index):
    """Raise on what the kernels do not take; return the rows and the
    index tensors contiguous and detached."""
    dev = rows.device
    _require_cuda(name, dev)
    if rows.dtype != torch.float32 or rows.dim() != 2 \
            or tuple(rows.shape) != (n_rows, 16):
        raise ValueError(f"rows must be ({n_rows}, 16) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for k, x in index.items():
        if x is None:
            raise ValueError(f"{name}_cuda needs {k}: bin with "
                             f"slot_tables=True")
        if x.dtype != torch.int64 or x.dim() != 1 or x.device != dev:
            raise ValueError(f"{k} must be 1-D int64 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} {x.device}")
    return [rows.detach().contiguous()] + [x.contiguous()
                                          for x in index.values()]


def _launch(name: str, dev: torch.device, *args):
    """The C function ``name`` on the tensors' and ints' ``args``, on the
    current stream of ``dev``."""
    with torch.cuda.device(dev):
        err = _bound(name, build.sources())(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def gather_entries_plain(packed: torch.Tensor, perm: torch.Tensor,
                         gidx_sorted: torch.Tensor) -> torch.Tensor:
    """(M, 16) entry rows: ``packed`` (N+1, 16) through the depth order
    ``perm`` (N,) extended by the sentinel N, then by ``gidx_sorted`` (M,).
    index_select, whose gradient is index_add_ (atomic adds on the card):
    indexing with [] differentiates into index_put_ with accumulation,
    which sorts the indices and then walks each one's duplicates serially,
    and every dead slot of the layout addresses the one sentinel row."""
    perm_ext = torch.cat([perm, perm.new_full((1,), packed.shape[0] - 1)])
    return packed.index_select(0, perm_ext).index_select(0, gidx_sorted)


def gather_entries_fwd_cuda(packed: torch.Tensor, perm: torch.Tensor,
                            gidx_sorted: torch.Tensor) -> torch.Tensor:
    """One launch: ``gather_entries_plain``'s rows, bit for bit. Not
    differentiable by itself: ``gather_entries_cuda`` is."""
    n = perm.shape[0]
    packed, perm, gidx_sorted = _check("gather_entries_fwd", packed, n + 1,
                                       perm=perm, gidx_sorted=gidx_sorted)
    m = gidx_sorted.shape[0]
    entries = torch.empty((m, 16), dtype=torch.float32,
                          device=packed.device)
    _launch("gather_entries_fwd", packed.device, packed, perm, gidx_sorted,
            n, m, entries)
    gather_entries_fwd_cuda.launches += 1
    return entries


gather_entries_fwd_cuda.launches = 0   # kernel launches since the last reset


def gather_entries_bwd_cuda(d_entries: torch.Tensor,
                            b: Binning) -> torch.Tensor:
    """One launch: d packed (N+1, 16) under the cotangent ``d_entries``
    (M, 16) of the layout ``b``, which must carry its slot tables: each
    gaussian's row the sum of its slots' rows in the order of its pairs,
    the same on every run; row N is 0."""
    n = b.perm.shape[0]
    d_entries, perm, slot_of, g_offsets, g_counts = _check(
        "gather_entries_bwd", d_entries, b.gidx_sorted.shape[0], perm=b.perm,
        slot_of=b.slot_of, g_offsets=b.g_offsets, g_counts=b.g_counts)
    d_packed = torch.empty((n + 1, 16), dtype=torch.float32,
                           device=d_entries.device)
    _launch("gather_entries_bwd", d_entries.device, d_entries, perm, slot_of,
            g_offsets, g_counts, n, slot_of.shape[0], d_entries.shape[0],
            d_packed)
    gather_entries_bwd_cuda.launches += 1
    return d_packed


gather_entries_bwd_cuda.launches = 0   # kernel launches since the last reset


class _GatherEntries(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient; only
    the packed rows are differentiable."""

    @staticmethod
    def forward(ctx, packed, b):
        ctx.binning = b
        return gather_entries_fwd_cuda(packed, b.perm, b.gidx_sorted)

    @staticmethod
    def backward(ctx, d_entries):
        return gather_entries_bwd_cuda(d_entries, ctx.binning), None


def gather_entries_cuda(packed: torch.Tensor, b: Binning) -> torch.Tensor:
    """Differentiable ``gather_entries_plain(packed, b.perm,
    b.gidx_sorted)`` through the two kernels. Where ``packed`` needs a
    gradient, ``b`` must carry its slot tables."""
    if torch.is_grad_enabled() and packed.requires_grad \
            and b.slot_of is None:
        raise ValueError("gather_entries_cuda's gradient needs the slot "
                         "tables: bin with slot_tables=True")
    return _GatherEntries.apply(packed, b)
