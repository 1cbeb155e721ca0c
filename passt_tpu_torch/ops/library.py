"""The serving kernels as ``torch.library`` custom ops.

The kernels are ``ctypes`` calls on raw pointers (``ops/_build.py``), which
``torch.export`` cannot trace. Each forward kernel that serving launches is
therefore one custom op with a fake (shape-only) version, so that an
exported program holds the op and runs the kernel when it is called:

- ``passt::log_mel``: the mel kernel (``ops/mel_kernel.py``, ``fused_log_mel``);
- ``passt::attention`` and ``passt::attention_qkv``: the attention forward
  kernel through its two entries (``ops/attention.py``, ``fused_attention``
  and ``fused_attention_qkv``);
- ``passt::ln_qkv_f1``: F1 (``ops/ln_qkv.py``), for ``fuse_ln_qkv`` models.

Each op runs the kernel on a CUDA tensor (``_build.LAUNCHES`` counts it
there, as before) and the plain version on a CPU tensor, and raises where
the kernel fails to build or launch. The wrappers and their autograd
functions call these ops, so the training path launches what it did.

Importing this module registers the ops; it imports ``torch`` and the
kernel wrappers, and nothing of ``models/`` or ``train/``: a process that
loads an exported program needs no more than this (``passt_tpu_torch.export``).
``passt_tpu_torch.ops`` imports it, so every wrapper finds its op.
"""

from __future__ import annotations

import torch

from passt_tpu_torch.ops.attention import attention_on_device, attention_qkv_on_device
from passt_tpu_torch.ops.ln_qkv import ln_qkv_f1_on_device
from passt_tpu_torch.ops.mel_kernel import log_mel_on_device, num_frames

#: every op this module registers, by name
OPS = ("passt::log_mel", "passt::attention", "passt::attention_qkv", "passt::ln_qkv_f1")


@torch.library.custom_op("passt::log_mel", mutates_args=())
def log_mel(wave: torch.Tensor, mel_bank: torch.Tensor, n_fft: int, hop: int, win_length: int,
            log_offset: float, norm_shift: float, norm_scale: float) -> torch.Tensor:
    """[B, T] wave + [n_mels, n_freq] bank -> [B, n_mels, frames] fp32 log-mel."""
    return log_mel_on_device(wave, mel_bank, n_fft, hop, win_length, log_offset, norm_shift, norm_scale)


@log_mel.register_fake
def _(wave, mel_bank, n_fft, hop, win_length, log_offset, norm_shift, norm_scale):
    b, t = wave.shape
    return wave.new_empty((b, mel_bank.shape[0], num_frames(t, hop)), dtype=torch.float32)


@torch.library.custom_op("passt::attention", mutates_args=())
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, plus1: bool) -> torch.Tensor:
    """softmax(q k^T * scale) v on ``[B, N, H, D]``, in q's dtype."""
    return attention_on_device(q, k, v, scale, plus1)


@attention.register_fake
def _(q, k, v, scale, plus1):
    return q.new_empty(q.shape)


@torch.library.custom_op("passt::attention_qkv", mutates_args=())
def attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int, scale: float, plus1: bool) -> torch.Tensor:
    """Attention over the raw qkv Dense output ``[B, N, 3C]`` -> ``[B, N, C]``."""
    return attention_qkv_on_device(qkv, heads, head_dim, scale, plus1)


@attention_qkv.register_fake
def _(qkv, heads, head_dim, scale, plus1):
    b, n, _ = qkv.shape
    return qkv.new_empty((b, n, heads * head_dim))


@torch.library.custom_op("passt::ln_qkv_f1", mutates_args=())
def ln_qkv_f1(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, w: torch.Tensor, wb: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm of x ``[B, N, C]`` then the qkv product: ``[B, N, 3C]`` in x's dtype."""
    return ln_qkv_f1_on_device(x, s, b, w, wb, eps)


@ln_qkv_f1.register_fake
def _(x, s, b, w, wb, eps):
    return x.new_empty(x.shape[:-1] + (w.shape[0],))
