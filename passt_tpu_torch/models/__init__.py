"""The PaSST model, arch registry and weight loading of the port."""

from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import (
    adapt_state_dict,
    flax_from_state_dict,
    load_params_npz,
    load_pretrained,
    load_torch_checkpoint,
    save_params_npz,
    stack_block_params,
    state_dict_from_flax,
    unstack_block_params,
)
from passt_tpu_torch.models.registry import ARCHS, DEFAULT_CFGS, get_model, get_model_config

__all__ = [
    "ARCHS",
    "DEFAULT_CFGS",
    "PaSST",
    "PaSSTConfig",
    "adapt_state_dict",
    "flax_from_state_dict",
    "get_model",
    "get_model_config",
    "load_params_npz",
    "load_pretrained",
    "load_torch_checkpoint",
    "save_params_npz",
    "stack_block_params",
    "state_dict_from_flax",
    "unstack_block_params",
]
