"""tanh-approximate GELU (port of passt_tpu/ops/activations.py, forward).

The value is computed in fp32 and cast back to the input dtype, as the JAX
package's ``_fwd_value``: PyTorch's gelu kernel computes bf16/fp16 inputs
in fp32 and rounds once, so this is one pass over the tensor (the same
formula written out op by op in eager PyTorch is ten). The custom backward
that saves the derivative belongs to the training slice.
"""

import torch
import torch.nn.functional as F


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
