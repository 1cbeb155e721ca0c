"""Text variants of one kernel source, built side by side on the card; shared
by ``ln_qkv_variants`` and ``fused_mlp_variants``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterator, Tuple

from passt_tpu_torch.ops import _build


def load(argv, default: Path) -> dict:
    """The variants file named by ``argv`` (or ``default``): a map from a
    variant name to a list of ``[old, new]`` text edits; an empty list is
    the source as it is."""
    return json.loads((Path(argv[0]) if argv else default).read_text())


def builds(kernel: str, variants: dict, lib_cache) -> Iterator[Tuple[str, str]]:
    """For each variant: write the kernel sources with the variant's edits of
    ``<kernel>.cu`` to ``build/<kernel>_variants/<name>/``, point the build
    there, clear the wrapper's library cache ``lib_cache`` (a
    ``functools.cache``) and build; yields the name and the compiler's
    output. The library name hashes the source, so each variant gets its
    own. The sources are pointed back at ``csrc`` at the end."""
    csrc = _build.CSRC
    try:
        for name, edits in variants.items():
            where = _build.BUILD_DIR.parent / f"{kernel}_variants" / name
            shutil.rmtree(where, ignore_errors=True)
            shutil.copytree(csrc, where)
            src = (where / f"{kernel}.cu").read_text()
            for old, new in edits:
                if old not in src:
                    raise SystemExit(f"variant {name}: text not found in {kernel}.cu: {old!r}")
                src = src.replace(old, new)
            (where / f"{kernel}.cu").write_text(src)
            _build.CSRC = where
            lib_cache.cache_clear()
            yield name, _build.build([kernel])[kernel]
    finally:
        _build.CSRC = csrc
        lib_cache.cache_clear()
