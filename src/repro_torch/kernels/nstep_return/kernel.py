"""Triton kernel: bulk n-step returns over a rollout, for Hopper.

Replaces the TPU kernel src/repro/kernels/nstep_return/kernel.py
(nstep_return_pallas). From ``(lanes, T)`` rewards and discounts it writes
the ``(lanes, T-n+1)`` returns and discount products

    returns[t]    = sum_{k<n} R[t+k] * prod_{j<k} gamma[t+j]
    discount_n[t] = prod_{k<n} gamma[t+k]

with the small horizon n unrolled statically: n shifted multiply-adds per
element, no reuse across elements, no tensor cores. Each program takes a
``(BLOCK_L, BLOCK_W)`` tile of lanes by window positions and masks the
ragged edges (Triton blocks are powers of two; the main path's window is
62 and its lane count 360).

What bounds it on the H100: bytes. It reads 2 x lanes x T floats and writes
2 x lanes x (T-n+1), about 0.36 MB on the main path, with a handful of
flops per element; the shifted loads of the n taps hit L1/L2 after the
first. At that size a launch costs more than the traffic, so the design
keeps it to one launch.

Triton is imported inside :func:`compiled`, on first launch, so the module
imports on machines without it.
"""

from __future__ import annotations

_kernel = None


def compiled():
    """The ``@triton.jit`` kernel, defined on first use."""
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def nstep_return_kernel(reward, discount, returns, disc_out, lanes, T, W,
                                N: tl.constexpr, BLOCK_L: tl.constexpr,
                                BLOCK_W: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_L + tl.arange(0, BLOCK_L)[:, None]
            cols = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)[None, :]
            mask = (rows < lanes) & (cols < W)
            acc = tl.zeros((BLOCK_L, BLOCK_W), dtype=tl.float32)
            disc = tl.full((BLOCK_L, BLOCK_W), 1.0, dtype=tl.float32)
            for k in tl.static_range(N):
                r = tl.load(reward + rows * T + cols + k, mask=mask, other=0.0)
                g = tl.load(discount + rows * T + cols + k, mask=mask, other=0.0)
                acc = acc + disc * r
                disc = disc * g
            tl.store(returns + rows * W + cols, acc, mask=mask)
            tl.store(disc_out + rows * W + cols, disc, mask=mask)

        _kernel = nstep_return_kernel
    return _kernel
