"""Differentiable dispatch for the hand-written CUDA kernels.

Counterpart of ``fsr_tpu/autodiff.py``.  A kernel has no autograd rule, so
the kernel path wraps each launch in a ``torch.autograd.Function`` whose
forward is the kernel (K1, K2 or K3: one launch, no graph) and whose
backward is autograd through the *torch twin*: the same configuration on
the plain-torch path (``impl="torch"``), re-run on the saved input.  That
path is differentiable end to end through the ideal-derivative rules of the
bit tricks (``core/approx.py``).

The backward therefore linearises the twin, not the kernel: the kernel's
own forms (the fast limiter, the quadratic-form tap distance) are within
the fidelity budget of the twin's but are not what is differentiated.
Under a loss that is linear in the output the kernel-path gradient is the
twin's gradient bit for bit; otherwise the incoming cotangent carries the
two forwards' difference.  The backward launches no kernel.

Auxiliary operands (grain, frame index, dither page) are closed over in the
two callables and get no gradient: they are noise and indices, not
trainable inputs.  A TEPD quantize (floor) has a zero gradient almost
everywhere, as in the JAX package.

Memory: the backward keeps the twin's saved tensors for one call, over a
hundred times the output's bytes (about 12 GiB for one float32 4K frame).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["kernel_with_torch_vjp"]


class _KernelWithTwin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_fn, twin_fn):
        ctx.twin_fn = twin_fn
        ctx.save_for_backward(x)
        return kernel_fn(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            v = x.detach().requires_grad_()
            out = ctx.twin_fn(v)
        (gx,) = torch.autograd.grad(out, v, g)
        return gx, None, None


def kernel_with_torch_vjp(kernel_fn: Callable, twin_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``kernel_fn(x)`` with backward = ``torch.autograd`` of ``twin_fn``.

    x: the differentiable image operand.  kernel_fn / twin_fn: ``x -> out``
    closures over the static configuration and the auxiliary operands; the
    twin computes the function the kernel approximates, on the torch path.
    """
    return _KernelWithTwin.apply(x, kernel_fn, twin_fn)
