"""Text variants of one kernel source, built side by side on the card; shared
by ``ln_qkv_variants``, ``fused_mlp_variants`` and ``attention_variants``."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Iterator, Tuple

from passt_tpu_torch.ops import _build


def load(argv, default: Path) -> dict:
    """The variants file named by an argument ending in ``.json`` (or
    ``default``): a map from a variant name to a list of ``[old, new]`` text
    edits; an empty list is the source as it is. The other arguments name
    the variants to keep (all of them when there are none)."""
    files = [a for a in argv if a.endswith(".json")]
    variants = json.loads((Path(files[0]) if files else default).read_text())
    names = [a for a in argv if not a.endswith(".json")]
    missing = [n for n in names if n not in variants]
    if missing:
        raise SystemExit(f"no such variants: {missing}")
    return {k: v for k, v in variants.items() if not names or k in names}


def registers(log: str, *fragments: str) -> Tuple[int, int]:
    """The most registers and spill-store bytes that ``ptxas -v`` reports
    for the entry functions whose mangled name contains every one of
    ``fragments`` (e.g. a kernel's name and ``Li32E``, one template
    instance's argument)."""
    regs, spills = [0], [0]
    for chunk in log.split("Compiling entry function")[1:]:
        if all(f in chunk.split("\n", 1)[0] for f in fragments):
            regs += [int(r) for r in re.findall(r"Used (\d+) registers", chunk)]
            spills += [int(x) for x in re.findall(r"(\d+) bytes spill stores", chunk)]
    return max(regs), max(spills)


def apply(kernel: str, name: str, src: str, edits) -> str:
    """``src`` (the text of ``<kernel>.cu``) with the variant's edits applied
    in order, each to every place its old text stands; an edit whose old
    text is missing stops the run."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: text not found in {kernel}.cu: {old!r}")
        src = src.replace(old, new)
    return src


def builds(kernel: str, variants: dict, lib_cache) -> Iterator[Tuple[str, str]]:
    """For each variant: write the kernel sources with the variant's edits of
    ``<kernel>.cu`` to ``build/<kernel>_variants/<name>/`` and build it (one
    ``nvcc`` per variant, all started together); then, variant by variant,
    point the build there, clear the wrapper's library cache ``lib_cache``
    (a ``functools.cache``) and yield the name and the compiler's output.
    A variant that does not build is reported and not yielded. The library
    name hashes the source, so each variant gets its own. The
    sources are pointed back at ``csrc`` at the end."""
    csrc = _build.CSRC
    try:
        where = {}
        for name, edits in variants.items():
            where[name] = _build.BUILD_DIR.parent / f"{kernel}_variants" / name
            shutil.rmtree(where[name], ignore_errors=True)
            shutil.copytree(csrc, where[name])
            src = (where[name] / f"{kernel}.cu").read_text()
            (where[name] / f"{kernel}.cu").write_text(apply(kernel, name, src, edits))
        jobs, started = {}, set()
        for name in variants:  # variants with the same source share one build
            _build.CSRC = where[name]
            path = _build.library_path(kernel)
            jobs[name] = None if path in started else _build._start(kernel)
            started.add(path)
        logs = {}
        for name, job in jobs.items():
            _build.CSRC = where[name]
            try:
                logs[name] = _build.finish(kernel, job)
            except RuntimeError as err:  # reported and skipped; the other variants still run
                notes = [ln for ln in str(err).splitlines() if "error" in ln]
                print(f"{name}: does not build: " + " | ".join(notes[:5]), flush=True)
        for name in variants:
            _build.CSRC = where[name]
            if name not in logs or not _build.library_path(kernel).exists():
                continue
            lib_cache.cache_clear()
            yield name, logs[name]
    finally:
        _build.CSRC = csrc
        lib_cache.cache_clear()
