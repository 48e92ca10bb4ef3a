"""What the entry gather's kernels are held to, shared by
tests/test_torch_gather_entries.py (the source built for the host) and
tests/test_torch_cuda.py (the card)."""
import torch


def bits(x):
    """The float32 tensor's bits, to compare NaN and -0.0 exactly."""
    return x.contiguous().view(torch.int32)


def sum_order_gap(got, d, perm, gidx):
    """Each row of the gather's gradient ``got`` (N+1, 16) under the
    cotangent ``d`` (M, 16) against the float64 sum of its live slots'
    rows: (entries past the float32 sum-order bound g sum |x| of a row of
    k slots, g = (k - 1) u / (1 - (k - 1) u) with u = 2^-24, the largest
    gap over its bound). A sum rounded as
    some order of float32 additions from 0 passes, whatever the order: the
    two ``index_add_``s of the plain chain and the kernel's sums alike.
    A row of one slot must be that slot's row exactly, a row of none 0."""
    n = perm.numel()
    live = gidx < n
    dst = perm[gidx[live]]
    d64 = d[live].double()
    z = torch.zeros((n + 1, 16), dtype=torch.float64, device=d.device)
    exact = z.index_add(0, dst, d64)
    mag = z.index_add(0, dst, d64.abs())
    k = torch.zeros(n + 1, dtype=torch.float64, device=d.device).index_add(
        0, dst, torch.ones(dst.numel(), dtype=torch.float64, device=d.device))
    ku = (k[:, None] - 1).clamp(min=0) * 2.0 ** -24
    bound = (ku / (1 - ku) * mag)[:n]
    gap = (got[:n].double() - exact[:n]).abs()
    over = gap > bound
    ratio = torch.where(bound > 0, gap / bound.clamp(min=1e-300), 0.0)
    return int(over.sum()), float(ratio.max())
