"""Frontend and attention ops of the port, with the Hopper kernels behind
``fused_log_mel`` and ``fused_attention`` / ``fused_attention_qkv`` (forward
and backward)."""

from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram, mel_frontend
from passt_tpu_torch.ops.mel import kaldi_mel_banks
from passt_tpu_torch.ops.mel_kernel import fused_log_mel

__all__ = [
    "MelConfig",
    "fused_attention",
    "fused_attention_qkv",
    "fused_log_mel",
    "kaldi_mel_banks",
    "log_mel_spectrogram",
    "mel_frontend",
]
