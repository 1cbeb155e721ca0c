"""Every text variant the variants tools build on the card applies to the
kernel source as it is: each edit's old text stands in the source at the
point the edit is applied, so no tool run stops on a stale edit."""

import json
from pathlib import Path

import pytest

from passt_tpu_torch.tools import variants as V

TOOLS = Path(V.__file__).parent
CSRC = TOOLS.parent / "csrc"


@pytest.mark.parametrize("kernel", ["attention_bwd", "attention_bwd_fp32", "attention_fwd", "attention_fwd_fp32",
                                    "fused_mlp", "ln_qkv", "mel_kernel"])
def test_every_variant_applies(kernel):
    names = {"attention_bwd": "attention_bwd", "attention_fwd": "attention", "mel_kernel": "mel"}
    path = TOOLS / f"{names.get(kernel, kernel)}_variants.json"
    variants = json.loads(path.read_text())
    src = (CSRC / f"{kernel}.cu").read_text()
    assert variants and "as_is" in variants and variants["as_is"] == []
    for name, edits in variants.items():
        out = V.apply(kernel, name, src, edits)
        assert (out != src) == bool(edits), f"variant {name} changes nothing"
