"""Tuner profile: the persisted selection table and tuned knob set.

Counterpart of ``mlsl_tpu.tuner.profile``: the load path and ``save``, which
the sweep (tuner/sweep.py) and the codec calibration (tuner/calibrate.py)
write theirs with. A profile is one JSON document keyed by a
topology fingerprint (``sysinfo.topology_fingerprint``). Cells map (kind,
group shape, compression, payload band) to an algorithm; knobs are whole-config
values. The file format is the JAX package's.

Load contract: a missing or corrupt file, an unknown version, an unknown
algorithm, an out-of-range value of a knob the port has or a string knob
outside its choices (``KNOB_CHOICES``: ``hier_dcn_codec``) is an MLSLError
at init. ``alltoall`` cells name ``lax`` or ``pallas_a2a``. The ``codecs``
table (request name -> calibration cell) must name registry codecs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

from mlsl_tpu_torch.log import MLSLError
from mlsl_tpu_torch.types import CompressionType

PROFILE_VERSION = 1
DEFAULT_PROFILE_FILE = "mlsl_tune_profile.json"

#: knob name -> minimum legal value, for the knobs the port's Config has
#: (the JAX package's limits). A profile's other knobs are not checked; the
#: tuner names them in a warning and applies none of them.
KNOB_RANGES = {
    "msg_priority_threshold": 1,
    "grad_bucket_mb": 0,
    "overlap_stages": 1,
    # the feed's prefetch depth (data/loader.py); an exported MLSL_FEED_DEPTH
    # wins
    "feed_depth": 1,
    "large_msg_size_mb": 0,
    "large_msg_chunks": 1,
    "quant_block_elems": 1,
    "pallas_rhd_max_bytes": 0,
    # the 'pallas_a2a' codec toggle, carried as 0/1 (a bool is rejected)
    "pallas_a2a_quant": 0,
    # the codec registry's whole-run knobs, beside the calibration's table
    "vq_dim": 1,
    "vq_codebook": 2,
    "prune_ratio": 1e-4,
    # the serving engine's decode slots, KV page size, KV budget (MiB) and
    # admission queue (serve/); an exported MLSL_SERVE_* wins
    "serve_max_batch": 1,
    "serve_kv_page_elems": 1,
    "serve_kv_cache_mb": 1,
    "serve_queue_depth": 1,
    # the integrity sentinel's audit interval (0 = off); an exported
    # MLSL_SENTINEL_EVERY wins
    "sentinel_every": 0,
}


#: string-valued knobs -> their legal values (the JAX package's), checked at
#: load like KNOB_RANGES: the 'hier' lowering's DCN codec
KNOB_CHOICES = {
    "hier_dcn_codec": ("int8", "f32", "topk", "vq", "prune"),
}


def default_profile_path() -> str:
    """Where an unnamed profile lands: ``MLSL_STATS_DIR`` (default the
    working directory), as ``mlsl_stats.log``."""
    d = os.environ.get("MLSL_STATS_DIR")
    return os.path.join(d, DEFAULT_PROFILE_FILE) if d else DEFAULT_PROFILE_FILE


def _comp_name(compression) -> str:
    if isinstance(compression, str):
        return compression
    try:
        return CompressionType(compression).name.lower()
    except ValueError:
        return str(compression)


@dataclasses.dataclass
class TunedProfile:
    """In-memory form of one profile document."""

    fingerprint: dict
    cells: List[dict] = dataclasses.field(default_factory=list)
    knobs: dict = dataclasses.field(default_factory=dict)
    created: str = ""
    # the codec calibration's table (tuner/calibrate.py): request name ->
    # {"codec", "block", "params", "nsr", "wire_bytes", "spectrum"}
    codecs: dict = dataclasses.field(default_factory=dict)

    def select(self, kind: str, shape: Tuple[int, ...], compression,
               payload_bytes: int) -> Optional[str]:
        """Tuned algorithm for (kind, group shape, compression, payload), or
        None when no cell covers it. The matching cell is the smallest
        ``max_bytes`` band that still covers the payload; ``max_bytes: null``
        is the open top band."""
        comp = _comp_name(compression)
        shape = tuple(int(s) for s in shape)
        best = best_cap = None
        for cell in self.cells:
            if cell.get("kind") != kind or _comp_name(cell.get("compression", "none")) != comp:
                continue
            if tuple(int(s) for s in cell.get("shape", ())) != shape:
                continue
            cap = cell.get("max_bytes")
            if cap is not None and payload_bytes > cap:
                continue
            if best is None or (cap is not None and (best_cap is None or cap < best_cap)):
                best, best_cap = cell, cap
        return best.get("algo") if best else None

    def matches(self, fingerprint: dict) -> bool:
        return dict(self.fingerprint) == dict(fingerprint)

    def to_doc(self) -> dict:
        doc = {"version": PROFILE_VERSION, "fingerprint": self.fingerprint,
               "created": self.created, "cells": self.cells, "knobs": self.knobs}
        if self.codecs:
            doc["codecs"] = self.codecs
        return doc

    def save(self, path: str) -> str:
        """Write the document atomically (a reader never sees half a file)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


def load_profile(path: str) -> TunedProfile:
    """Parse a profile file; MLSLError on a missing, corrupt or invalid one."""
    if not os.path.exists(path):
        raise MLSLError(f"MLSL_TUNE_PROFILE points at a missing file: {path}")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise MLSLError(f"MLSL_TUNE_PROFILE file {path} is unreadable or corrupt: {e!r}") from e
    if not isinstance(doc, dict) or "fingerprint" not in doc or "cells" not in doc:
        raise MLSLError(f"MLSL_TUNE_PROFILE file {path} is not a tuner profile "
                        f"(missing fingerprint/cells)")
    if doc.get("version") != PROFILE_VERSION:
        raise MLSLError(f"MLSL_TUNE_PROFILE file {path} has unsupported version "
                        f"{doc.get('version')!r} (this build reads version {PROFILE_VERSION})")
    cells = doc["cells"]
    if not isinstance(cells, list) or not all(isinstance(c, dict) for c in cells):
        raise MLSLError(f"MLSL_TUNE_PROFILE file {path} has a malformed cell table")
    from mlsl_tpu_torch.comm import algos

    for cell in cells:
        algos.check_name(cell.get("algo"), f"MLSL_TUNE_PROFILE file {path}: algorithm")
    knobs = doc.get("knobs", {}) or {}
    for name, lo in KNOB_RANGES.items():
        v = knobs.get(name)
        if v is None:
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)) or v < lo:
            raise MLSLError(f"MLSL_TUNE_PROFILE file {path} has invalid knob {name}={v!r} "
                            f"(expected a number >= {lo})")
    for name, choices in KNOB_CHOICES.items():
        v = knobs.get(name)
        if v is not None and v not in choices:
            raise MLSLError(f"MLSL_TUNE_PROFILE file {path} has invalid knob {name}={v!r} "
                            f"(expected one of {', '.join(choices)})")
    codec_cells = doc.get("codecs", {}) or {}
    if not isinstance(codec_cells, dict) or not all(
            isinstance(k, str) and isinstance(v, dict) and isinstance(v.get("codec"), str)
            for k, v in codec_cells.items()):
        raise MLSLError(f"MLSL_TUNE_PROFILE file {path} has a malformed codecs table "
                        f"(expected request name -> {{'codec': name, ...}})")
    from mlsl_tpu_torch import codecs as codecs_mod

    for rname, cell in codec_cells.items():
        if cell["codec"] not in codecs_mod.names():
            raise MLSLError(f"MLSL_TUNE_PROFILE file {path} assigns unknown codec "
                            f"{cell['codec']!r} to {rname!r} "
                            f"(registry: {', '.join(codecs_mod.names())})")
    return TunedProfile(fingerprint=doc["fingerprint"], cells=cells, knobs=knobs,
                        created=str(doc.get("created", "")), codecs=codec_cells)
