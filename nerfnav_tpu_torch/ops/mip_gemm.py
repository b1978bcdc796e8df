"""mip-NeRF's wide MLP layers as one GEMM with its elementwise work fused.

`gemm_bias_act` is a layer's forward, bf16(act(a @ w + bias)), and
`gemm_dgrad_mask` its input gradient, d = g @ w.T (+ a rank-1 term) set to 0
where the saved activation is <= 0, returned as bf16(d) and the column sums of
d (the bias gradient of the layer below). For a CUDA tensor each launches the
hand-written kernel of csrc/mip_gemm.cu, or raises; for a CPU tensor each runs
its plain twin (`gemm_bias_act_plain`, `gemm_dgrad_mask_plain`), the eager
torch chain the kernel replaces, which is also its yardstick on the card.

Precision is the chain's on either path: bf16 operands with float32 products
and sums (`mm32`), the float32 bias, one rounding to bf16, float32 column
sums; only the kernel's order of the K sum differs from cuBLAS's.

Each call counts `mip_gemm_kernel_calls` or `mip_gemm_plain_calls` in the
innermost span while tracing; `gemm_bias_act.launches` and
`gemm_dgrad_mask.launches` count the kernel launches.
"""

import functools

import torch

from nerfnav_tpu_torch.utils.profiling import count

_BF = torch.bfloat16
_ROWS = 64          # the kernel's rows a tile
_WARPS = 8          # consumer warps a block: partial column sums a block


def mm32(a, b, bias=None):
    """a @ b (+ bias) of bf16 operands with float32 products, sums and
    result: one bf16 pass at float32 accumulation, what a TPU's default
    matmul precision gives mip-NeRF's JAX code. On the CPU the operands are
    widened, which multiplies them exactly."""
    if a.is_cuda:
        if bias is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(bias, a, b, out_dtype=torch.float32)
    out = a.float() @ b.float()
    return out if bias is None else out + bias


def gemm_bias_act_plain(a, w, bias, relu=True):
    """bf16(act(a @ w + bias)) as eager torch ops (rounding and relu
    commute); w's rows past its own count as zeros."""
    if w.shape[0] < a.shape[1]:
        w = torch.cat([w, w.new_zeros((a.shape[1] - w.shape[0], w.shape[1]))])
    y = mm32(a, w, bias).to(_BF)
    return y.relu_() if relu else y


def gemm_dgrad_mask_plain(g, w, saved=None, rank1=None):
    """(bf16(d), d.sum(0)) of d = g @ w.T (+ gd ws.T), 0 where saved <= 0, as
    eager torch ops."""
    d = mm32(g, w.t())
    if rank1 is not None:
        gd, ws = rank1
        d = d + gd.float() * ws.float().t()
    if saved is not None:
        d.masked_fill_(saved <= 0, 0.0)
    return d.to(_BF), d.sum(dim=0)


def _check_matrix(name, t, rows, cols, dtype, device):
    if t.dim() != 2 or (rows is not None and t.shape[0] != rows) or \
            (cols is not None and t.shape[1] != cols):
        raise ValueError(f"{name} must be ({rows}, {cols}), got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {dtype} on {device}, got {t.dtype} on {t.device}")
    if t.shape[0] > 1 and t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}'s rows must be contiguous, got strides {t.stride()}")


def _check_kernel(a, n, max_k):
    """Raises ValueError on a CUDA call the kernel does not take; max_k: the
    largest K it keeps in shared memory for each N it takes."""
    k = a.shape[1]
    if n not in max_k:
        raise ValueError(f"the mip GEMM kernel takes N in {tuple(max_k)}, got {n}")
    if k % 16 or not 0 < k <= max_k[n]:
        raise ValueError(f"the mip GEMM kernel takes K a multiple of 16 up to {max_k[n]} "
                         f"at N = {n}, got {k}")
    if a.shape[0] >= 2**31:
        raise ValueError(f"the mip GEMM kernel takes M < 2^31, got {a.shape[0]}")
    if a.stride(0) % 8 or a.data_ptr() % 16:
        raise ValueError("the mip GEMM kernel takes an A 16-byte aligned with a row "
                         f"stride a multiple of 8, got stride {a.stride(0)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(m, device):
    return max(1, min(_sm_count(device.index), -(-m // _ROWS)))


def _call(fn, *args):
    from nerfnav_tpu_torch import kernels

    err = getattr(kernels.load("mip_gemm"), fn)(*args)
    if err != 0:
        raise RuntimeError(f"mip GEMM kernel {fn} failed: CUDA error {err}")
    count("mip_gemm_kernel_calls", 1)


def gemm_bias_act(a, w, bias, relu=True, out=None):
    """bf16(act(a @ w + bias)) of a layer: a (M, K) bf16 with contiguous rows,
    w (K_w, N) bf16 with contiguous rows, K_w <= K (the rows past K_w count
    as zeros: a's padding columns), bias (N,) float32, act relu (relu=True)
    or none. Written into out, a bf16 (M, N) with contiguous rows (a column
    block of a wider buffer, say), or a new tensor; returns it. On the card
    N is 256 or 128 and K a multiple of 16."""
    _check_matrix("a", a, None, None, _BF, a.device)
    m, k = a.shape
    _check_matrix("w", w, None, None, _BF, a.device)
    if not 0 < w.shape[0] <= k:
        raise ValueError(f"w must have 1 to {k} rows, got {tuple(w.shape)}")
    n = w.shape[1]
    if bias.shape != (n,) or bias.dtype != torch.float32 or bias.device != a.device:
        raise ValueError(f"bias must be ({n},) float32 on {a.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if out is not None:
        _check_matrix("out", out, m, n, _BF, a.device)
    if not a.is_cuda:
        count("mip_gemm_plain_calls", 1)
        y = gemm_bias_act_plain(a, w, bias, relu)
        return y if out is None else out.copy_(y)
    _check_kernel(a, n, {256: 384, 128: 768})
    if w.stride(0) % 8 or w.data_ptr() % 16:
        raise ValueError("the mip GEMM kernel takes a w 16-byte aligned with a row stride "
                         "a multiple of 8")
    if out is None:
        out = torch.empty((m, n), dtype=_BF, device=a.device)
    elif out.stride(0) % 8 or out.data_ptr() % 16:
        raise ValueError("the mip GEMM kernel writes 16 bytes a thread: out must be 16-byte "
                         "aligned with a row stride a multiple of 8")
    if m:
        _call("nerfnav_mip_gemm_bias_act", a.data_ptr(), a.stride(0), w.data_ptr(),
              w.stride(0), w.shape[0], bias.contiguous().data_ptr(), out.data_ptr(),
              out.stride(0), m, n, k, int(relu), _blocks(m, a.device),
              torch.cuda.current_stream(a.device).cuda_stream)
        gemm_bias_act.launches += 1
    return out


def gemm_dgrad_mask(g, w, saved=None, rank1=None):
    """(bf16(d), d.sum(0) in float32) of d = g @ w.T, plus gd ws.T when rank1
    = (gd (M, 1), ws (N, 1)) bf16 is given, set to 0 where saved (M, N) bf16
    (the activation this gradient flows into, a view with contiguous rows)
    is <= 0 when given. g (M, K) bf16 with contiguous rows; w (N, K) bf16:
    the first N rows of the layer's (K_in, K) weight. On the card N is 256
    and K a multiple of 16. The column sums are summed in a fixed order: the
    same bits every run."""
    _check_matrix("g", g, None, None, _BF, g.device)
    m, k = g.shape
    _check_matrix("w", w, None, k, _BF, g.device)
    n = w.shape[0]
    if saved is not None:
        _check_matrix("saved", saved, m, n, _BF, g.device)
    if rank1 is not None:
        gd, ws = rank1
        _check_matrix("gd", gd, m, 1, _BF, g.device)
        _check_matrix("ws", ws, n, 1, _BF, g.device)
    if not g.is_cuda:
        count("mip_gemm_plain_calls", 1)
        return gemm_dgrad_mask_plain(g, w, saved, rank1)
    _check_kernel(g, n, {256: 256})
    if w.stride(0) % 8 or w.data_ptr() % 16:
        raise ValueError("the mip GEMM kernel takes a w 16-byte aligned with a row stride "
                         "a multiple of 8")
    if saved is not None and (saved.stride(0) % 8 or saved.data_ptr() % 16):
        raise ValueError("the mip GEMM kernel reads 16 bytes a thread: saved must be 16-byte "
                         "aligned with a row stride a multiple of 8")
    out = torch.empty((m, n), dtype=_BF, device=g.device)
    if not m:
        return out, torch.zeros(n, device=g.device)
    blocks = _blocks(m, g.device)
    sums = torch.empty((blocks * _WARPS, n), device=g.device)
    gd, ws = (None, None) if rank1 is None else (rank1[0].contiguous(), rank1[1].contiguous())
    _call("nerfnav_mip_gemm_dgrad_mask", g.data_ptr(), g.stride(0), w.data_ptr(), w.stride(0),
          None if saved is None else saved.data_ptr(), 0 if saved is None else saved.stride(0),
          None if gd is None else gd.data_ptr(), None if ws is None else ws.data_ptr(),
          out.data_ptr(), n, sums.data_ptr(), m, n, k, blocks,
          torch.cuda.current_stream(g.device).cuda_stream)
    gemm_dgrad_mask.launches += 1
    return out, sums.sum(dim=0)


gemm_bias_act.launches = 0
gemm_dgrad_mask.launches = 0
