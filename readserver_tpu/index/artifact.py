"""Versioned directory artifact for a built index.

The reference's "checkpoint" is its immutable on-disk index (SGA ``.bwt`` +
RocksDB dir; SURVEY.md §5 "Checkpoint / resume").  Here: a directory of raw
``.npy`` arrays (memory-mappable for fast reload) plus ``manifest.json``
carrying the build-time ``IndexConfig``, corpus hash and format version, so
serve-time configuration can never drift from build-time.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from readserver_tpu.config import IndexConfig
from readserver_tpu.index.builder import PackedIndex

_ARRAYS = [
    "C",
    "symbol_counts",
    "rank_blocks",
    "sym4",
    "dollar_map",
    "read_to_sample",
    "read_lengths",
    "corpus_packed",
    "read_offsets",
]
_OPTIONAL_ARRAYS = [
    "lf", "mark_rank", "sample_pairs", "dsa", "fused_rows",
    "rank2_blocks", "C2", "rank3_blocks", "C3",
    "name_blob", "name_offsets", "meta_blob", "meta_offsets",
]

MANIFEST_NAME = "manifest.json"


def corpus_fingerprint(index: PackedIndex) -> str:
    h = hashlib.sha256()
    h.update(index.corpus_packed.tobytes())
    h.update(index.read_offsets.tobytes())
    h.update(index.read_to_sample.tobytes())
    return h.hexdigest()[:16]


def save_artifact(index: PackedIndex, path: str | Path) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = list(_ARRAYS)
    for name in _OPTIONAL_ARRAYS:
        if getattr(index, name) is not None:
            arrays.append(name)
    for name in arrays:
        np.save(path / f"{name}.npy", getattr(index, name))
    manifest = {
        "format_version": index.config.format_version,
        "config": json.loads(index.config.to_json()),
        "n": index.n,
        "num_reads": index.num_reads,
        "num_samples": index.num_samples,
        "sample_names": index.sample_names,
        "corpus_fingerprint": corpus_fingerprint(index),
        "arrays": arrays,
        "sample_rate": index.sample_rate,
        "dsa_bits": index.dsa_bits,
    }
    tmp = path / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.rename(path / MANIFEST_NAME)  # manifest last: presence == complete
    return path


def load_artifact(path: str | Path, mmap: bool = True) -> PackedIndex:
    path = Path(path)
    manifest = json.loads((path / MANIFEST_NAME).read_text())
    config = IndexConfig(**manifest["config"])
    if manifest["format_version"] != config.format_version:
        raise ValueError(
            f"artifact format v{manifest['format_version']} != "
            f"supported v{config.format_version}"
        )
    mode = "r" if mmap else None
    # "files" maps array name → non-default filename: upgrade-in-place
    # rewrites (e.g. a sample_rate change) write versioned files and flip
    # this mapping atomically with the manifest, so a crash mid-rewrite
    # can never mix old- and new-rate arrays
    files = manifest.get("files", {})
    arrays = {
        name: np.load(path / files.get(name, f"{name}.npy"), mmap_mode=mode)
        for name in manifest["arrays"]
    }
    return PackedIndex(
        config=config,
        n=manifest["n"],
        num_reads=manifest["num_reads"],
        num_samples=manifest["num_samples"],
        sample_names=manifest["sample_names"],
        sample_rate=manifest.get("sample_rate", 0),
        dsa_bits=manifest.get("dsa_bits", 0),
        **arrays,
    )


def artifact_exists(path: str | Path) -> bool:
    return (Path(path) / MANIFEST_NAME).exists()
