"""Frontend, attention, LayerNorm and int8 Dense ops of the port, with the
Hopper kernels behind ``fused_log_mel``, ``fused_attention`` /
``fused_attention_qkv`` (forward and backward), ``layer_norm`` (backward),
``fused_ln_qkv_attention`` (F1 and B2) and ``int8_dense`` /
``int8_dense_gelu`` / ``int8_matmul`` (one int8 GEMM)."""

from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram, mel_frontend
from passt_tpu_torch.ops.int8 import int8_dense, int8_dense_gelu, int8_dense_nd, int8_matmul
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
    "int8_dense",
    "int8_dense_gelu",
    "int8_dense_nd",
    "int8_matmul",
    "kaldi_mel_banks",
    "layer_norm",
    "log_mel_spectrogram",
    "mel_frontend",
]
