"""Frontend, attention and LayerNorm ops of the port, with the Hopper kernels
behind ``fused_log_mel``, ``fused_attention`` / ``fused_attention_qkv``
(forward and backward), ``layer_norm`` (backward) and
``fused_ln_qkv_attention`` (F1 and B2)."""

from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram, mel_frontend
from passt_tpu_torch.ops.layernorm import layer_norm
from passt_tpu_torch.ops.ln_qkv import fused_ln_qkv_attention
from passt_tpu_torch.ops.mel import kaldi_mel_banks
from passt_tpu_torch.ops.mel_kernel import fused_log_mel

__all__ = [
    "MelConfig",
    "fused_attention",
    "fused_attention_qkv",
    "fused_ln_qkv_attention",
    "fused_log_mel",
    "kaldi_mel_banks",
    "layer_norm",
    "log_mel_spectrogram",
    "mel_frontend",
]
