from passt_tpu_torch.utils.params import count_params, count_non_zero_params, param_summary

__all__ = ["count_params", "count_non_zero_params", "param_summary"]
