"""The plain reference against the port at a tiny size on the CPU: the
frontend, the eval logits, and the train step's draws, made again by the
frozen copy of the port's seeding."""

import pytest
import torch

from benchmark.lib import draws as D
from benchmark.lib import flops, program, reference, weights as Wt
from benchmark.tests._tiny import tiny_cell


def _mel():
    return tiny_cell("passt_s.serve.b20").config["mel"]


def test_log_mel_matches_the_port():
    from passt_tpu_torch.ops.frontend import log_mel_spectrogram

    mel = _mel()
    waves, _ = Wt.make_clips(3, 1, 3, 31360, 10, 0.0, torch.device("cpu"))
    ours = reference.log_mel(waves[0], mel, 0.0, mel["sr"] // 2 - mel["fmax_aug_range"] // 2)
    theirs = log_mel_spectrogram(waves[0], program.mel_config(mel))
    assert ours.shape == theirs.shape
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-4)


def test_fp32_eval_logits_match_the_port():
    from passt_tpu_torch.hear import Predictor

    cell = tiny_cell("passt_s.serve.b20")
    cfg = dict(cell.config, dtype="float32")
    dev = torch.device("cpu")
    w = Wt.make_weights(cfg, 5, dev)
    waves, _ = Wt.make_clips(5, 1, 4, 31360, cfg["num_classes"], 0.0, dev)
    net = program.model(cfg, w, dev).eval()
    theirs = Predictor(model=net, mel_cfg=program.mel_config(cfg["mel"]), jit=False)(waves[0])
    ours = reference.eval_logits(w, waves[0], cfg, cfg["mel"])
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


def test_the_control_departs_from_the_reference():
    cell = tiny_cell("passt_s.serve.b20")
    dev = torch.device("cpu")
    w = Wt.make_weights(cell.config, 6, dev)
    waves, _ = Wt.make_clips(6, 1, 4, 31360, 10, 0.0, dev)
    ref = reference.eval_logits(w, waves[0], cell.config, cell.config["mel"])
    low = reference.eval_logits(w, waves[0], cell.config, cell.config["mel"], low=True)
    assert (low - ref).abs().max() > 1e-2 * ref.abs().max()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
@pytest.mark.parametrize("step, total", [(0, 4), (2, 12)])
def test_draws_match_the_ports(seed, step, total):
    """The frozen seeding and draw order give the port's own draws."""
    from passt_tpu_torch.models.passt import _sorted_keep_indices
    from passt_tpu_torch.ops.frontend import _axis_mask
    from passt_tpu_torch.train.mixup import sample_mixup
    from passt_tpu_torch.train.steps import step_generators

    cell = tiny_cell("passt_s.train.b12")
    cfg, mel, m = cell.config, cell.config["mel"], cell.params["model"]
    dev = torch.device("cpu")
    frames = Wt.mel_frames(mel, cell.params["clip_samples"])
    grid = flops.grid(cfg, frames)
    ours = D.step_draws(seed, step, total, frames, mel, m, grid, dev)
    g = step_generators(seed, step, dev)
    fmin = torch.randint(0, mel["fmin_aug_range"], (), generator=g["mel"]).float()
    fmax = torch.randint(0, mel["fmax_aug_range"], (), generator=g["mel"]).float()
    assert float(ours["fmin"]) == mel["fmin"] + float(fmin)
    assert float(ours["fmax"]) == mel["sr"] // 2 - mel["fmax_aug_range"] // 2 + mel["fmax_aug_range"] // 2 - float(fmax)
    assert torch.equal(ours["freq_mask"], _axis_mask(g["mel"], total, mel["n_mels"], mel["freqm"], False)[0])
    assert torch.equal(ours["time_mask"], _axis_mask(g["mel"], total, frames, mel["timem"], False)[0])
    perm, lam = sample_mixup(g["mix"], total, m["mixup_alpha"])
    assert torch.equal(ours["perm"], perm) and torch.equal(ours["lam"], lam)
    assert torch.equal(ours["keep_t"], _sorted_keep_indices(g["patchout"], grid[1], grid[1] - m["s_patchout_t"]))
    assert torch.equal(ours["keep_f"], _sorted_keep_indices(g["patchout"], grid[0], grid[0] - m["s_patchout_f"]))


def test_expected_sr_norm():
    """The storage model against stochastic rounding drawn many times."""
    gen = torch.Generator().manual_seed(0)
    p0 = (0.02 * torch.randn(4096, generator=gen)).to(torch.bfloat16).float()
    updates = [3e-7 * torch.sign(torch.randn(4096, generator=gen)) for _ in range(3)] + [2e-4 * torch.randn(4096, generator=gen)]
    norms = []
    for _ in range(64):
        p = p0.clone()
        for u in updates:
            x = p + u
            r = torch.randint(0, 1 << 16, x.shape, generator=gen, dtype=torch.int32)
            p = ((x.view(torch.int32) + r) & -65536).view(torch.float32)
        norms.append(float((p - p0).norm()))
    assert sum(norms) / len(norms) == pytest.approx(reference.expected_sr_norm(p0, updates), rel=0.03)
