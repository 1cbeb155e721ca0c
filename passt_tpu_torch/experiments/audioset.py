"""AudioSet-2M recipe (reference: ex_audioset.py; port of passt_tpu/experiments/audioset.py).

Defaults: PaSST-S stride 10, 527 classes, structured patchout (40, 4),
mel fmin/fmax jitter (10, 2000), freqm 48 / timem 192, batch 12, wavmix +
roll + gain on, class-balanced weighted sampler with 100k draws/epoch,
AdamW lr 2e-5 wd 1e-4, exp-warmup(5) x linear-down(start 50, len 50, floor
1%), mixup alpha 0.3, SWA from epoch 50 every 5, 130 epochs, bf16 compute
(the reference trains with trainer.precision=16).

CLI: ``python -m passt_tpu_torch.cli audioset [command] [preset|key=value ...]``
"""

from passt_tpu_torch.config import DataConfig, ExperimentConfig, MelConfig, ModelSelect, TrainerConfig
from passt_tpu_torch.experiments.common import Experiment

experiment = Experiment(
    name="audioset",
    default_config=ExperimentConfig(
        name="audioset",
        model=ModelSelect(n_classes=527, s_patchout_t=40, s_patchout_f=4),
        mel=MelConfig(freqm=48, timem=192, fmin_aug_range=10, fmax_aug_range=2000),
        data=DataConfig(
            num_classes=527,
            clip_length=10,
            batch_size=12,
            wavmix=True,
            roll=True,
            weighted_sampler=True,
            epoch_len=100000,
        ),
        trainer=TrainerConfig(
            max_epochs=130,
            lr=2e-5,
            loss_type="multilabel",
            swa=True,
            swa_epoch_start=50,
            swa_freq=5,
        ),
    ),
)

if __name__ == "__main__":
    import sys

    from passt_tpu_torch.experiments.common import run_command

    run_command(experiment, sys.argv[1:])
