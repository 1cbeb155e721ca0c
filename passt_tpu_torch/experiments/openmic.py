"""OpenMIC-2018 recipe (reference: ex_openmic.py; port of passt_tpu/experiments/openmic.py).

Deltas vs AudioSet: 20 instrument classes with observed-label masks
(targets = [20 labels || 20 masks], float, no packbits;
openmic/dataset.py:199-201), masked BCE (the mask multiplies the loss,
ex_openmic.py:172-177), mask-merging wavmix (openmic/dataset.py:117-137),
batch 6, lr 1e-5, 10 epochs, SWA from epoch 2 every epoch.
"""

from passt_tpu_torch.config import DataConfig, ExperimentConfig, MelConfig, ModelSelect, TrainerConfig
from passt_tpu_torch.experiments.common import Experiment

experiment = Experiment(
    name="openmic",
    default_config=ExperimentConfig(
        name="openmic",
        model=ModelSelect(n_classes=20, s_patchout_t=40, s_patchout_f=4),
        mel=MelConfig(freqm=48, timem=192, fmin_aug_range=10, fmax_aug_range=2000),
        data=DataConfig(
            num_classes=40,  # 20 labels + 20 masks stored per item
            clip_length=10,
            batch_size=6,
            wavmix=True,
            roll=True,
            weighted_sampler=False,
            packed_targets=False,
            merge_mask_wavmix=True,
        ),
        trainer=TrainerConfig(
            max_epochs=10,
            lr=1e-5,
            loss_type="masked",
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
