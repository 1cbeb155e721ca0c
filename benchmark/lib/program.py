"""The benchmark's one door into the program under test
(``passt_tpu_torch``): its model built from a configuration file, with the
benchmark's weights loaded. Nothing of the program is imported until a
function here runs, and only the port's public modules are."""

from __future__ import annotations

from typing import Dict

import torch


def mel_config(mel: dict):
    from passt_tpu_torch.ops.frontend import MelConfig

    return MelConfig(n_mels=mel["n_mels"], sr=mel["sr"], win_length=mel["win_length"], hopsize=mel["hopsize"],
                     n_fft=mel["n_fft"], freqm=mel["freqm"], timem=mel["timem"], fmin=mel["fmin"],
                     fmin_aug_range=mel["fmin_aug_range"], fmax_aug_range=mel["fmax_aug_range"])


def model(cfg: dict, weights: Dict[str, torch.Tensor], device, **overrides):
    """The program's PaSST at the configuration's sizes and precision, built
    on ``device``, holding ``weights`` (every leaf, by its published name)."""
    from passt_tpu_torch.models.passt import PaSST, PaSSTConfig

    pcfg = PaSSTConfig(
        input_fdim=cfg["input_fdim"], input_tdim=cfg["input_tdim"], patch_size=tuple(cfg["patch_size"]),
        stride=tuple(cfg["stride"]), in_chans=cfg["in_chans"], num_classes=cfg["num_classes"],
        embed_dim=cfg["embed_dim"], depth=cfg["depth"], num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"],
        qkv_bias=cfg["qkv_bias"], distilled=cfg["distilled"], dtype=cfg["dtype"], gelu=cfg["gelu"], **overrides)
    with torch.device(device):
        net = PaSST(pcfg)
    names = {k for k, _ in net.named_parameters()}
    if names != set(weights):
        raise RuntimeError(f"the program's leaves differ from the published ones: "
                           f"{sorted(names ^ set(weights))[:8]}")
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(weights[k])
    return net
