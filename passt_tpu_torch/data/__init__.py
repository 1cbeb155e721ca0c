"""The port's data layer (port of passt_tpu/data): numpy datasets and
samplers copied from the JAX package, the loader and prefetcher, and the
pinned side-stream feed to the card."""

from passt_tpu_torch.data.datasets import (
    AudioDataset,
    HDF5AudioDataset,
    ConcatDataset,
    MapDataset,
    RollDataset,
    WavMixDataset,
    CachedDataset,
    FolderDataset,
    pad_or_truncate,
    random_crop,
    stride_resample,
    roll_augment,
    gain_augment,
    ir_augment,
    load_ir_bank,
)
from passt_tpu_torch.data.sampler import (
    class_balanced_sample_weights,
    WeightedEpochSampler,
    ShuffleSampler,
    SequentialSampler,
)
from passt_tpu_torch.data.pipeline import DataLoader, DeviceFeed, Prefetcher

__all__ = [
    "AudioDataset",
    "HDF5AudioDataset",
    "ConcatDataset",
    "MapDataset",
    "RollDataset",
    "WavMixDataset",
    "CachedDataset",
    "FolderDataset",
    "pad_or_truncate",
    "random_crop",
    "stride_resample",
    "roll_augment",
    "gain_augment",
    "ir_augment",
    "load_ir_bank",
    "class_balanced_sample_weights",
    "WeightedEpochSampler",
    "ShuffleSampler",
    "SequentialSampler",
    "DataLoader",
    "DeviceFeed",
    "Prefetcher",
]
