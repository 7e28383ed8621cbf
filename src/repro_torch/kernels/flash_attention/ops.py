"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the framework's (B, S, H, D) layout and hands the
kernel (B, H, S, D) views of the same memory (strides, no copies), as the
JAX package's ``ops.py`` swaps axes around its Pallas call. For CUDA
tensors it launches the kernel on PyTorch's current stream, or raises; for
CPU tensors it runs the plain version (``ref.py``). ``launches`` counts
kernel launches and nothing else.

Differentiation: ``flash_attention`` is a ``torch.autograd.Function`` whose
forward is the kernel and whose backward recomputes attention through
``models/layers.attention_chunked`` (no (Sq, Sk) residuals saved), as the
JAX package's ``custom_vjp`` does. There is no backward kernel there
either.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import attention_chunked

launches = 0
HEAD_DIMS = (32, 64, 80, 128)         # D and Dv each; plus (D, Dv) = (192, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def supported(D: int, Dv: int) -> bool:
    return (D in HEAD_DIMS and Dv in HEAD_DIMS) or (D, Dv) == (192, 128)


def _launch(q, k, v, out, *, causal, window, q_offset, scale) -> None:
    """Launch on (B, H, S, D) views whose last stride is 1."""
    global launches
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    dev, dtype = q.device, q.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention: expected bf16 or f32, got {dtype}")
    if not supported(D, Dv):
        raise ValueError(f"flash_attention: head sizes D={D}, Dv={Dv} not supported "
                         f"(each of {HEAD_DIMS}, or D=192 with Dv=128)")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of Hkv={Hkv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    for name, t, shape in (("q", q, (B, Hq, Sq, D)), ("k", k, (B, Hkv, Sk, D)),
                           ("v", v, (B, Hkv, Sk, Dv)), ("out", out, (B, Hq, Sq, Dv))):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"flash_attention {name}: expected {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention {name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        # rows are read 16 bytes at a time: a unit last stride, and the
        # start and every other stride on 16-byte boundaries
        es = t.element_size()
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s * es % 16 for s in t.stride()[:3])):
            raise ValueError(f"flash_attention {name}: expected contiguous rows on "
                             f"16-byte boundaries, got strides {t.stride()}")
    if B == 0 or Hq == 0 or Sq == 0:
        return
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = _build.launcher("flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[dtype],
            B, Hq, Hkv, Sq, Sk, D, Dv, *strides,
            float(scale if scale is not None else D ** -0.5),
            int(causal), -1 if window is None else int(window), int(q_offset),
            _build.stream_of(q))
    _build.check_launch("flash_attention", rc)
    launches += 1


def _forward(q, k, v, causal, window, q_offset, scale):
    """(B, S, H, D) in and out."""
    if q.device.type == "cpu":
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal, window=window,
                                   q_offset=q_offset, scale=scale).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, _ = q.shape
    out = torch.empty((B, Sq, Hq, v.shape[-1]), dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset, scale=scale)
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset, scale, chunk)
        return _forward(q, k, v, causal, window, q_offset, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, q_offset, scale, chunk = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_chunked(*inputs, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale, chunk=chunk)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset: int = 0,
                    scale=None, block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D/Dv) -> (B,Sq,Hq,Dv).

    ``q_offset`` is a host integer. ``block_q`` and ``block_k`` are the TPU
    kernel's tile sizes; the CUDA kernel tiles 64 x 64 whatever they say,
    and ``block_k`` sets the backward's chunk (``max(block_k, 128)``) as in
    the JAX package."""
    del block_q
    return _Flash.apply(q, k, v, causal, window, int(q_offset), scale,
                        max(block_k, 128))
