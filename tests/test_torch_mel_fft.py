"""The Hopper mel kernel's order (csrc/mel_kernel.cu), emulated in fp32
PyTorch on the CPU, against the JAX frontend and the port's plain version.

The emulation repeats the kernel step by step: the pre-emphasised samples
at torch's reflect index, the window and the packing of a frame as
n_fft / 2 complex points, the Stockham passes in the kernel's radices with
its fp32 twiddle tables, the real-to-complex post-step by pairs of bins
(k, n_fft / 2 - k), and the mel sum over each row's non-zero span (two
sums, over its even and odd places). The JAX
side runs its Pallas kernel in interpret mode where its ``kernel_supports``
holds (hop 320), and its XLA frontend (``stft_method="matmul"``) at hops
160 and 100, which the TPU kernel refuses. Every comparison uses
chip_smoke's ``mel_strong_check`` bounds: 1e-3 on the normalised log-mel,
2e-4 wherever the mel energy exceeds 1e-2 (fp32 summation order, which the
log amplifies in near-empty bins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu.ops.frontend import log_mel_spectrogram as jax_log_mel
from passt_tpu.ops.pallas.mel_kernel import fused_log_mel as jax_fused_log_mel
from passt_tpu.ops.pallas.mel_kernel import kernel_supports as jax_kernel_supports
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops import mel_kernel as K
from passt_tpu_torch.ops.mel import kaldi_mel_banks, kaldi_mel_banks_np
from passt_tpu_torch.ops.stft import preemphasis, reflect_pad_center

SQRT_HALF = torch.tensor(np.float32(np.sqrt(0.5)))


def _check(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    strong = np.exp(5.0 * ref - 4.5) > 1e-2
    np.testing.assert_allclose(got[strong], ref[strong], atol=2e-4, rtol=0)


def stage(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The samples the kernel stages, for every padded index j: y at the
    reflected index, y[i] = x[i+1] - 0.97 x[i] (a rounded multiply, then a
    rounded subtract)."""
    length, pad = x.shape[1] - 1, n_fft // 2
    idx = torch.arange(length + 2 * pad) - pad
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx >= length, 2 * (length - 1) - idx, idx)
    return x[:, idx + 1] - x[:, idx] * torch.tensor(np.float32(0.97))


def _mul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _dft(v, radix):
    """The kernel's dft<R> on a list of (re, im) pairs."""
    if radix == 2:
        (ar, ai), (br, bi) = v
        return [(ar + br, ai + bi), (ar - br, ai - bi)]
    if radix == 4:
        (r0, i0), (r1, i1), (r2, i2), (r3, i3) = v
        t0, t1 = (r0 + r2, i0 + i2), (r0 - r2, i0 - i2)
        t2 = (r1 + r3, i1 + i3)
        t3 = (i1 - i3, -(r1 - r3))  # -i (v1 - v3)
        return [(t0[0] + t2[0], t0[1] + t2[1]), (t1[0] + t3[0], t1[1] + t3[1]),
                (t0[0] - t2[0], t0[1] - t2[1]), (t1[0] - t3[0], t1[1] - t3[1])]
    e, o = _dft(v[0::2], 4), _dft(v[1::2], 4)
    (x1, y1), (x2, y2), (x3, y3) = o[1], o[2], o[3]
    o = [o[0], ((x1 + y1) * SQRT_HALF, (y1 - x1) * SQRT_HALF), (y2, -x2),
         ((y3 - x3) * SQRT_HALF, -(x3 + y3) * SQRT_HALF)]
    return ([(e[k][0] + o[k][0], e[k][1] + o[k][1]) for k in range(4)]
            + [(e[k][0] - o[k][0], e[k][1] - o[k][1]) for k in range(4)])


def stockham(re, im, radices, ptw):
    """The kernel's M-point Stockham FFT over the last axis, pass by pass,
    with its passes' twiddle tables ``ptw`` ([n_fft / 2, 2])."""
    m = re.shape[-1]
    ns, off = 1, 0
    for radix in radices:
        bf = m // radix
        j = torch.arange(bf)
        k = j % ns
        v = [(re[..., j + r * bf], im[..., j + r * bf]) for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                w = ptw[off + (r - 1) * ns + k]
                v[r] = _mul(v[r][0], v[r][1], w[:, 0], w[:, 1])
            off += (radix - 1) * ns
        v = _dft(v, radix)
        base = (j // ns) * ns * radix + k
        re, im = torch.empty_like(re), torch.empty_like(im)
        for r in range(radix):
            re[..., base + r * ns], im[..., base + r * ns] = v[r]
        ns *= radix
    return re, im


def emulate(wave, bank, *, n_fft=1024, hop=320, win_length=800, log_offset=1e-5, norm_shift=4.5,
            norm_scale=5.0):
    """The kernel's function in its own order: [B, T] -> [B, n_mels, frames]."""
    x = torch.as_tensor(wave, dtype=torch.float32)
    bank = torch.as_tensor(bank, dtype=torch.float32)
    tables = torch.from_numpy(K.fft_tables(n_fft, win_length))
    tw, win = tables[: 2 * n_fft].view(n_fft, 2), tables[3 * n_fft:]
    frames = 1 + (x.shape[1] - 1) // hop
    framed = stage(x, n_fft).unfold(1, n_fft, hop)[:, :frames] * win  # [B, F, n_fft]
    m = n_fft // 2
    ptw = tables[2 * n_fft : 3 * n_fft].view(n_fft // 2, 2)
    zr, zi = stockham(framed[..., 0::2], framed[..., 1::2], K.fft_radices(n_fft), ptw)
    n_mels, n_freq = bank.shape
    # the post-step by pairs: bins k and M - k (k <= M / 2) from the same
    # loads, X_{M-k} = conj(E_k - W^k O_k)
    k = torch.arange(m // 2 + 1)
    km = (m - k) % m
    ar, ai, br, bi = zr[..., k], zi[..., k], zr[..., km], zi[..., km]
    er, ei, orr, oi = 0.5 * (ar + br), 0.5 * (ai - bi), 0.5 * (ai + bi), 0.5 * (br - ar)
    wr, wi = tw[k, 0], tw[k, 1]
    tr, ti = wr * orr - wi * oi, wr * oi + wi * orr
    power = torch.zeros(*zr.shape[:-1], m + 1)
    power[..., m - k] = (er - tr) * (er - tr) + (ei - ti) * (ei - ti)
    power[..., k] = (er + tr) * (er + tr) + (ei + ti) * (ei + ti)  # bin M / 2: this one
    power = power[..., :n_freq]  # [B, F, n_freq]
    spans = K.mel_spans_plain(bank)
    mel = torch.zeros(x.shape[0], n_mels, frames)
    for row in range(n_mels):  # two sums, over the span's even and odd places
        acc = [torch.zeros(x.shape[0], frames), torch.zeros(x.shape[0], frames)]
        lo = int(spans[row, 0])
        for kb in range(lo, int(spans[row, 1])):
            acc[(kb - lo) % 2] = acc[(kb - lo) % 2] + bank[row, kb] * power[..., kb]
        mel[:, row] = acc[0] + acc[1]
    return (torch.log(mel + log_offset) + norm_shift) / norm_scale


def _wave(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_fft_plan_and_tables():
    """The radices multiply to n_fft / 2; the table's twiddles and window
    are the float64 values rounded once."""
    for n_fft, want in ((64, (4, 8)), (512, (4, 8, 8)), (1024, (8, 8, 8)), (2048, (2, 8, 8, 8))):
        assert K.fft_radices(n_fft) == want
        assert np.prod(want) == n_fft // 2
    t = K.fft_tables(1024, 800)
    u = np.arange(1024)
    np.testing.assert_array_equal(t[0:2048:2], np.cos(2 * np.pi * u / 1024).astype(np.float32))
    np.testing.assert_array_equal(t[1:2048:2], (-np.sin(2 * np.pi * u / 1024)).astype(np.float32))
    # the second pass (ns = 8) and the third (ns = 64): entry (r - 1) ns + k is the twiddle of k r
    ptw, tw = t[2048:3072].reshape(512, 2), t[:2048].reshape(1024, 2)
    for off, ns in ((0, 8), (56, 64)):
        for r in range(1, 8):
            k = np.arange(ns)
            np.testing.assert_array_equal(ptw[off + (r - 1) * ns + k], tw[k * r * (1024 // (8 * ns))])
    assert (ptw[56 + 7 * 64:] == 0).all()
    assert t.dtype == np.float32 and (t[3072:3072 + 112] == 0).all() and (t[3072 + 912:] == 0).all()


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 2048])
def test_stockham_passes_match_fft(n_fft):
    """The kernel's passes and post-step give the real FFT's power."""
    frame = torch.from_numpy(_wave(n_fft, (3, n_fft)))
    ptw = torch.from_numpy(K.fft_tables(n_fft, n_fft)[2 * n_fft : 3 * n_fft]).view(n_fft // 2, 2)
    zr, zi = stockham(frame[:, 0::2], frame[:, 1::2], K.fft_radices(n_fft), ptw)
    ref = np.fft.fft(frame[:, 0::2].double().numpy() + 1j * frame[:, 1::2].double().numpy(), axis=-1)
    np.testing.assert_allclose(zr.numpy() + 1j * zi.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_staged_samples_equal_the_plain_padding():
    """The staged samples are bit-equal to reflect_pad_center(preemphasis(x))."""
    for n_fft, t in ((1024, 5000), (1024, 514), (512, 259), (2048, 1400)):
        x = torch.from_numpy(_wave(t, (2, t)))
        assert torch.equal(stage(x, n_fft), reflect_pad_center(preemphasis(x), n_fft))


@pytest.mark.parametrize("n_fft, win_length", [(512, 400), (1024, 800), (2048, 800)])
def test_emulation_matches_pallas_kernel_at_hop_320(n_fft, win_length):
    wave = _wave(n_fft, (2, 12000))
    bank = kaldi_mel_banks(128, n_fft, 32000, 0.0, 15000.0)
    assert jax_kernel_supports(320, n_fft)
    kw = dict(n_fft=n_fft, hop=320, win_length=win_length)
    got = emulate(wave, bank, **kw).numpy()
    ref = np.asarray(jax_fused_log_mel(jnp.asarray(wave), jnp.asarray(bank.numpy()), interpret=True, **kw))
    _check(got, ref)
    _check(got, K.fused_log_mel_plain(torch.from_numpy(wave), bank, **kw).numpy())


@pytest.mark.parametrize("hop", [160, 100])
def test_emulation_matches_xla_frontend_at_hops_the_tpu_kernel_refuses(hop):
    assert not jax_kernel_supports(hop, 1024)
    wave = _wave(hop, (2, 9600))
    cfg = JaxMelConfig(hopsize=hop, fmin_aug_range=10, fmax_aug_range=2000, stft_method="matmul")
    ref = np.asarray(jax_log_mel(jnp.asarray(wave), cfg))
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    got = emulate(wave, bank, hop=hop).numpy()
    _check(got, ref)
    _check(got, K.fused_log_mel_plain(torch.from_numpy(wave), bank, hop=hop).numpy())


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_emulation_on_a_wave_just_long_enough(n_fft):
    """n_fft / 2 + 2 samples: one more than the reflect padding needs."""
    t = n_fft // 2 + 2
    wave = _wave(t, (2, t))
    bank = kaldi_mel_banks(128, n_fft, 32000, 0.0, 15000.0)
    win = 400 if n_fft == 512 else 800
    got = emulate(wave, bank, n_fft=n_fft, win_length=win)
    assert got.shape == (2, 128, 1 + (t - 1) // 320)
    _check(got.numpy(), K.fused_log_mel_plain(torch.from_numpy(wave), bank, n_fft=n_fft, win_length=win).numpy())
    with pytest.raises(RuntimeError):  # one sample fewer: F.pad refuses, as the kernel's wrapper does
        K.fused_log_mel_plain(torch.from_numpy(wave[:, :-1]), bank, n_fft=n_fft, win_length=win)


def _spans_np(bank):
    out = np.zeros((bank.shape[0], 2), dtype=np.int32)
    for m, row in enumerate(bank):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out


def test_span_finder_on_default_and_jittered_banks():
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    spans = K.mel_spans_plain(bank).numpy()
    np.testing.assert_array_equal(spans, _spans_np(bank.numpy()))
    widths = spans[:, 1] - spans[:, 0]
    assert int((bank != 0).sum()) == 947 == int(np.count_nonzero(kaldi_mel_banks_np(128, 1024, 32000, 0, 15000)))
    assert widths.max() == 24 and widths.sum() >= 947
    rng = np.random.default_rng(7)
    for _ in range(4):  # the training frontend's jitter of fmin and fmax
        fmin, fmax = float(rng.integers(0, 10)), 15000.0 + 1000 - float(rng.integers(0, 2000))
        bank = kaldi_mel_banks(128, 1024, 32000, torch.tensor(fmin), torch.tensor(fmax))
        np.testing.assert_array_equal(K.mel_spans_plain(bank).numpy(), _spans_np(bank.numpy()))


def test_span_finder_and_emulation_on_a_synthetic_bank():
    """An all-zero row gives log(log_offset); a full-width row sums every bin."""
    bank = kaldi_mel_banks(16, 512, 32000, 0.0, 15000.0).clone()
    bank[3] = 0.0
    bank[9] = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 1.0, 256).astype(np.float32))
    spans = K.mel_spans_plain(bank).numpy()
    np.testing.assert_array_equal(spans, _spans_np(bank.numpy()))
    assert tuple(spans[3]) == (0, 0) and tuple(spans[9]) == (0, 256)
    wave = _wave(11, (1, 6000))
    got = emulate(wave, bank, n_fft=512, win_length=400).numpy()
    np.testing.assert_array_equal(got[:, 3], np.float32((np.log(np.float32(1e-5)) + 4.5) / 5.0))
    _check(got, K.fused_log_mel_plain(torch.from_numpy(wave), bank, n_fft=512, win_length=400).numpy())


def test_geometry_gate():
    wave, bank = torch.zeros(1, 4000), kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    assert all(K.kernel_supports(n) for n in (64, 512, 1024, 2048))
    assert not any(K.kernel_supports(n) for n in (1000, 1536, 32, 4096))
    _build.reset_launches()
    for n_fft in (1000, 1536):
        with pytest.raises(ValueError, match=f"n_fft={n_fft}.*stft_method='matmul'"):
            K.fused_log_mel(wave, bank[:, : n_fft // 2], n_fft=n_fft, win_length=800)
    assert _build.LAUNCHES["fused_log_mel"] == 0


@pytest.mark.parametrize("n_fft, n_mels", [(1000, 64), (1024, 300)])
def test_auto_takes_matmul_where_the_kernel_refuses(n_fft, n_mels):
    """Outside the kernel's geometry "auto" runs the plain "matmul"
    formulation, as the JAX frontend's "auto" does; "pallas" raises."""
    from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram

    assert not K.kernel_supports(n_fft, n_mels)
    wave = _wave(n_fft + n_mels, (2, 6000))
    kw = dict(n_fft=n_fft, n_mels=n_mels)
    got = log_mel_spectrogram(torch.from_numpy(wave), MelConfig(**kw))
    plain = log_mel_spectrogram(torch.from_numpy(wave), MelConfig(stft_method="matmul", **kw))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    _check(got.numpy(), np.asarray(jax_log_mel(jnp.asarray(wave), JaxMelConfig(**kw))))
    with pytest.raises(ValueError, match="mel kernel needs"):
        log_mel_spectrogram(torch.from_numpy(wave), MelConfig(stft_method="pallas", **kw))
