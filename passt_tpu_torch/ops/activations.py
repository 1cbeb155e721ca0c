"""tanh-approximate GELU with a saved-derivative backward (port of
passt_tpu/ops/activations.py).

The forward returns the value and saves the DERIVATIVE ``d = gelu'(x)``
instead of the pre-activation, as the JAX package's custom VJP does; the
backward is then one multiply with no transcendentals.

Numerics, as the JAX package's ``_fwd``/``_bwd``: value and derivative are
computed in fp32 and each is rounded once to the input dtype; the backward
is ``g * d`` in fp32, rounded to the input dtype. PyTorch's gelu kernels
compute bf16/fp16 inputs in fp32 and round once, so each of these is one
pass over the tensor: the value is ``F.gelu(x, approximate="tanh")``, the
derivative is ``gelu_backward`` of a gradient of ones (the analytic
derivative of the same formula), and ``g * d`` multiplies in fp32 and rounds
once. PyTorch's own gelu backward would recompute from ``x`` and round
``g * d`` once; this rounds ``d`` first, like the JAX package.
"""

import torch
import torch.nn.functional as F


class _TanhGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.requires_grad:
            ones = torch.ones((), dtype=x.dtype, device=x.device).expand_as(x)
            ctx.save_for_backward(torch.ops.aten.gelu_backward(ones, x, approximate="tanh"))
        return F.gelu(x, approximate="tanh")

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return g * d


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU; its backward multiplies by the saved derivative."""
    return _TanhGelu.apply(x)
