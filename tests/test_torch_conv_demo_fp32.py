"""The convergence demo's reduced PaSST at ``model.dtype=float32`` in the
port against the JAX package, on the CPU: the slice whose attention calls
take the fp32 "simt" kernels at D = 32 on the card.

The demo (``tools/convergence_demo``) trains PaSST 4 x 192 with 6 heads, so
every attention call is fp32 at D = 32 when it runs at
``model.dtype=float32``: ``forward_path`` and ``backward_path`` send each to
"simt" (``csrc/attention_fwd_fp32.cu``, ``csrc/attention_bwd_fp32.cu``). On
CPU tensors the port's wrappers run the plain versions of those kernels'
function; the JAX model runs its Pallas attention kernels in interpret mode.
Here the depth is cut to 2 (the width, heads and input length are the
demo's: 192, 6 heads of D = 32, 98 frames, so N = 110 tokens in eval), the
weights go from the JAX init to the port with ``state_dict_from_flax``, the
spectrogram and the loss weights come from a numpy seed, and the logits and
every parameter's gradient of ``sum(logits * w)`` are compared. The same
holds at 2 heads (D = 96) and 8 heads (D = 24), the head counts an
``ArchSpec`` override gives that reach the padded "simt" instances (DP = 96
and 32) on the card, as chip_smoke [20h] runs the demo at 2 heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops.attention import backward_path, forward_path
from passt_tpu_torch.tools.convergence_demo import OVERRIDES, REDUCED

#: the demo's reduced PaSST (tools/convergence_demo REDUCED, its input
#: length and the ESC-50 recipe's 50 classes) at depth 2, fp32, the
#: attention kernels' entry points
DEMO = dict(REDUCED, depth=2, input_tdim=int(OVERRIDES["model.input_tdim"]), num_classes=50,
            dtype="float32", attn_impl="fused")
# the same fp32 function in two frameworks' CPU kernels, in other summation
# orders: the logits to test_torch_model.py's fp32 bound, 2e-4 absolute
# (observed 6e-7); each gradient relative to its leaf's max|g|, 1e-4
# (observed 1.1e-6)
TOL_LOGITS, TOL_GRAD = 2e-4, 1e-4


def test_demo_width_is_d32_on_simt():
    """Width 192 over 6 heads: D = 32, which takes "simt" both ways at the
    demo's training (N = 79) and eval (N = 110) token counts."""
    d = DEMO["embed_dim"] // DEMO["num_heads"]
    assert d == 32
    for n in (79, 110):
        assert forward_path(n, d, torch.float32, True) == backward_path(n, d, torch.float32, True) == "simt"


def _logits_and_gradients_match_jax(cfg: dict) -> None:
    """The port's reduced PaSST at ``cfg`` against the JAX model: logits
    and every parameter's gradient, within TOL_LOGITS and TOL_GRAD."""
    jmodel, params = init_passt(JaxConfig(**cfg), jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 1, 128, cfg["input_tdim"])).astype(np.float32)
    w = rng.standard_normal((2, cfg["num_classes"])).astype(np.float32)

    def loss(p):
        logits, _ = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return jnp.sum(logits * w), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))

    model = PaSST(PaSSTConfig(**cfg))
    model.load_state_dict(state_dict_from_flax(params))
    model.eval()
    logits, _ = model(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=TOL_LOGITS, rtol=0)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    held = 0
    for name, g in got.items():
        ref = torch.as_tensor(want[name])
        if g is None:  # outside the eval forward (the distillation head): zero in JAX too
            assert not bool(ref.any()), f"{name}: no port gradient, JAX's is not zero"
            continue
        assert g.shape == ref.shape, name
        scale = float(ref.abs().max())
        err = float((g - ref).abs().max())
        assert err <= TOL_GRAD * scale, f"{name}: max err {err:.3g} of max|g| {scale:.3g}"
        held += 1
    # every leaf of the two blocks (their attention's qkv and proj among them) is held
    assert held >= 2 * 12


def test_reduced_passt_fp32_logits_and_gradients_match_jax():
    _logits_and_gradients_match_jax(DEMO)


@pytest.mark.parametrize("heads, head_dim", [(2, 96), (8, 24)])
def test_reduced_passt_fp32_other_heads_match_jax(heads, head_dim):
    """The demo's width over 2 heads (D = 96: the DP = 96 instances) and 8
    heads (D = 24: DP = 32 with 8 zero columns), each taking "simt" both
    ways on the card at the demo's token counts."""
    cfg = dict(DEMO, num_heads=heads)
    assert cfg["embed_dim"] // heads == head_dim
    for n in (79, 110):
        assert forward_path(n, head_dim, torch.float32, True) == backward_path(n, head_dim, torch.float32,
                                                                               True) == "simt"
    _logits_and_gradients_match_jax(cfg)
