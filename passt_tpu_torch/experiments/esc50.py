"""ESC-50 fine-tune recipe (reference: ex_esc50.py; port of passt_tpu/experiments/esc50.py).

Deltas vs AudioSet: 50 classes single-label CE (mixup = lambda-weighted sum
of two CE terms), 5-s clips, patchout (10, 3), timem 80, lr 1e-5, 10
epochs, SWA from epoch 2 every epoch, no weighted sampler (shuffle), fold-
based cross-validation handled at dataset-packing time (one HDF5 per fold
split; the reference filters a CSV by fold at esc50/dataset.py:138-152).
"""

from passt_tpu_torch.config import DataConfig, ExperimentConfig, MelConfig, ModelSelect, TrainerConfig
from passt_tpu_torch.experiments.common import Experiment

experiment = Experiment(
    name="esc50",
    single_label=True,
    speed_test_batch_size=100,  # reference harness default, ex_esc50.py:281
    default_config=ExperimentConfig(
        name="esc50",
        model=ModelSelect(n_classes=50, s_patchout_t=10, s_patchout_f=3),
        mel=MelConfig(freqm=48, timem=80, fmin_aug_range=10, fmax_aug_range=2000),
        data=DataConfig(
            num_classes=50,
            clip_length=5,
            batch_size=12,
            eval_batch_size=20,
            wavmix=False,
            roll=True,
            weighted_sampler=False,
            packed_targets=False,
        ),
        trainer=TrainerConfig(
            max_epochs=10,
            lr=1e-5,
            loss_type="single_label",
            swa=True,
            swa_epoch_start=2,
            swa_freq=1,
        ),
    ),
)

if __name__ == "__main__":
    import sys

    from passt_tpu_torch.experiments.common import run_command

    run_command(experiment, sys.argv[1:])
