"""HEAR-style inference API: waveform in, logits/embeddings out
(port of passt_tpu/hear.py).

A :class:`Predictor` bundles the frontend config and the model behind one
waveform -> (logits, features) function, run under ``torch.inference_mode``.
On a CUDA device that function goes through the Hopper mel kernel and the
Hopper attention kernel, and runs as CUDA graphs, one per input shape (the
JAX package's jitted ``Predictor``; ``jit=False`` runs it eagerly, and so
does a CPU model). The HEAR entry points ``load_model``,
``get_scene_embeddings`` and ``get_timestamp_embeddings`` follow hear21passt.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from passt_tpu_torch import graphs
from passt_tpu_torch.models.passt import PaSST
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram


def inference_forward(model: PaSST, mel_cfg: MelConfig, input_tdim: int, wave: torch.Tensor):
    """waveform [B, T] float32 -> (logits [B, C], features [B, D]): eval-mode
    mel, cropped to ``input_tdim`` frames, then the eval-mode forward. What
    :func:`make_inference_fn` runs, and what ``passt_tpu_torch.export``
    traces (without the inference mode, which tracing refuses)."""
    mel = log_mel_spectrogram(wave, mel_cfg, train=False)
    return model(mel[:, None, :, :input_tdim], train=False)


def make_inference_fn(model: PaSST, mel_cfg: MelConfig, input_tdim: int) -> Callable:
    """:func:`inference_forward` of ``model`` under ``torch.inference_mode``."""

    def infer(wave: torch.Tensor):
        with torch.inference_mode():
            return inference_forward(model, mel_cfg, input_tdim, wave)

    return infer


def default_inference_mel_cfg(arch: str) -> MelConfig:
    """The frontend the published checkpoints were evaluated with: the
    AudioSet recipe's fmin_aug_range=10 and fmax_aug_range=2000, so the eval
    fmax is sr//2 - 1000 = 15000; the stfthop archs use their own hop."""
    from passt_tpu_torch.models.registry import ARCHS

    hop = ARCHS[arch].hopsize if arch in ARCHS else 320
    return MelConfig(hopsize=hop, fmin_aug_range=10, fmax_aug_range=2000)


@dataclasses.dataclass
class Predictor:
    """Waveform-in inference bundle.

    >>> p = Predictor.create(arch="passt_s_swa_p16_128_ap476",
    ...                      checkpoint_path=".../passt-s-f128-p16-s10-ap.476-swa.pt")
    >>> logits = p(wave)                # [B, 527] AudioSet logits
    >>> emb = p.scene_embeddings(wave)  # [B, 1295] logits ‖ features (mode="all")
    """

    model: PaSST
    mel_cfg: MelConfig
    # hear21passt's embedding modes: "all" = logits ‖ features, "logits",
    # "embed_only" = the averaged CLS/DIST features
    mode: str = "all"
    #: windows per forward in timestamp_embeddings; the tail chunk is
    #: padded to this size, so every clip length runs one shape
    timestamp_chunk: int = 256
    #: CUDA graphs of the inference function on a CUDA device (one per input
    #: shape: B = 1, B = 20 and the timestamp chunk each get one); the
    #: outputs are copies the next call leaves alone
    jit: bool = True
    _apply: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(
        cls,
        arch: str = "passt_s_swa_p16_128_ap476",
        checkpoint_path: Optional[str] = None,
        mel_cfg: Optional[MelConfig] = None,
        dtype: str = "bfloat16",
        mode: str = "all",
        device="cuda",
        generator: Optional[torch.Generator] = None,
        jit: bool = True,
        **overrides,
    ) -> "Predictor":
        """Build the model on ``device`` (the card by default; without a
        CUDA device pass ``device="cpu"``): random weights from
        ``generator`` unless ``checkpoint_path`` is given."""
        from passt_tpu_torch.models.registry import ARCHS, get_model

        if mel_cfg is None:
            mel_cfg = default_inference_mel_cfg(arch)
        if arch in ARCHS:
            # the checkpoint's own time grid (20/30-sec and stfthop archs)
            overrides.setdefault("input_tdim", ARCHS[arch].input_tdim)
        model = get_model(
            arch=arch,
            pretrained=checkpoint_path is not None,
            checkpoint_path=checkpoint_path,
            generator=generator,
            device=device,
            dtype=dtype,
            **overrides,
        )
        return cls(model=model, mel_cfg=mel_cfg, mode=mode, jit=jit)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _fn(self) -> Callable:
        if self._apply is None:
            infer = make_inference_fn(self.model, self.mel_cfg, self.model.cfg.input_tdim)
            if self.jit:
                # the model's tensors are read in place: passed so that the
                # cache keys its graphs on them
                cache = graphs.GraphCache(lambda wave, _tensors: infer(wave))
                self._apply = lambda wave: cache(wave, graphs.InPlace(self._model_tensors()))[0]
            else:
                self._apply = infer
        return self._apply

    def _model_tensors(self) -> list:
        return [*self.model.parameters(), *self.model.buffers()]

    def _wave(self, wave) -> torch.Tensor:
        return torch.as_tensor(wave, dtype=torch.float32, device=self.device)

    def __call__(self, wave) -> torch.Tensor:
        """[B, T] float32 waveform at 32 kHz -> [B, num_classes] logits."""
        logits, _ = self._fn()(self._wave(wave))
        return logits

    def logits_and_features(self, wave) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._fn()(self._wave(wave))

    def _embed(self, logits, feats, mode: Optional[str]) -> torch.Tensor:
        mode = mode or self.mode
        if mode == "all":
            return torch.cat([logits, feats], dim=-1)
        if mode == "logits":
            return logits
        if mode == "embed_only":
            return feats
        raise ValueError(f"unknown embedding mode {mode!r}; known: all / logits / embed_only")

    def scene_embeddings(self, wave, mode: Optional[str] = None) -> torch.Tensor:
        """[B, T] -> [B, D] clip embedding; D = n_classes + 768 for "all"."""
        logits, feats = self._fn()(self._wave(wave))
        return self._embed(logits, feats, mode)

    def timestamp_embeddings(
        self, wave, window_seconds: float = 0.16, hop_seconds: float = 0.05,
        mode: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] -> ([B, N, D] embeddings, [B, N] timestamps in ms).

        The clip is zero-padded by half a window on both sides, so window n
        is centred on sample n * hop and even a clip shorter than a window
        gives one; windows run through the model in chunks of
        ``timestamp_chunk``, the last one padded."""
        wave = self._wave(wave)
        sr = self.mel_cfg.sr
        win = int(window_seconds * sr)
        hop = int(hop_seconds * sr)
        b, t = wave.shape
        padded = F.pad(wave, (win // 2, win - win // 2))
        starts = np.arange(0, t, hop)  # window starts in padded coordinates
        n_win = len(starts)
        stacked = padded.unfold(1, win, hop)[:, :n_win].reshape(b * n_win, win)
        chunk = self.timestamp_chunk
        fn = self._fn()
        outs = []
        for lo in range(0, len(stacked), chunk):
            part = stacked[lo : lo + chunk]
            n_real = len(part)
            if n_real < chunk:
                part = F.pad(part, (0, 0, 0, chunk - n_real))
            logits, feats = fn(part)
            outs.append(self._embed(logits, feats, mode)[:n_real])
        emb = torch.cat(outs).reshape(b, n_win, -1)
        grid = starts / sr * 1000.0
        timestamps = torch.as_tensor(
            np.broadcast_to(grid, (b, n_win)).copy(), dtype=torch.float32, device=emb.device
        )
        return emb, timestamps


# hear21passt drop-in module surface (the HEAR benchmark entry points).
def load_model(model_file_path: Optional[str] = None, **kwargs) -> Predictor:
    """HEAR entry point: build the inference model; ``model_file_path`` is a
    local ``.pt`` or ``.npz`` checkpoint, None = random weights."""
    return Predictor.create(checkpoint_path=model_file_path or None, **kwargs)


def get_scene_embeddings(audio, model: Predictor) -> torch.Tensor:
    """HEAR entry point: [B, T] audio -> [B, D] clip embeddings."""
    return model.scene_embeddings(audio)


def get_timestamp_embeddings(audio, model: Predictor):
    """HEAR entry point: [B, T] audio -> ([B, N, D], [B, N] ms timestamps)."""
    return model.timestamp_embeddings(audio)
