"""Codec calibration at commit (``MLSL_TUNE_CODEC=1``).

Counterpart of ``mlsl_tpu.tuner.calibrate`` (calibrate.py:34-232). At
Session.commit, before the gradient buckets form, each QUANTIZATION
gradient set's deterministic, layer-shaped gradient sample goes through the
encode/decode round trip of every candidate codec, and the set gets the
cheapest candidate (fewest wire bytes) whose noise-to-signal power ratio
(NSR) stays within ``MLSL_CODEC_NSR_BUDGET``. int8 at the session's block is
always a candidate, so no set calibrates to a worse wire than the default.
The table is merged into the topology-keyed tuned profile (tuner/profile.py's
``codecs`` section) and applied to the live requests, which are set up again.

An exported ``MLSL_CODEC`` wins: the profile still records the measurement,
and the live assignment stays. The guardrail (``codecs.guard_note``) demotes
a calibrated set whose loss goes wrong.

The samples are made in numpy, as in the JAX package (the same seeds, the
same arrays), and encoded on the Environment's device: on the card, every
int8 candidate is one B1 launch (``quantize_blocks``) and one B2 launch
(``dequantize_blocks``).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mlsl_tpu_torch.log import MLSLError, log_info, log_warning
from mlsl_tpu_torch.tuner.profile import TunedProfile, default_profile_path, load_profile

#: cap on a set's sample length: the NSR settles well before it
SAMPLE_CAP = 65536

#: the int8 blocks searched (the session's block is added to them)
INT8_BLOCKS = (128, 256, 512)

#: prune keep ratios searched
PRUNE_RATIOS = (0.01, 0.05, 0.1, 0.25)

#: VQ vector lengths searched (the codebook size is MLSL_VQ_CODEBOOK)
VQ_DIMS = (4, 8)

#: sets of at least this many elements are modelled as a wide layer: 90 % of
#: the sample exactly zero (dead ReLU units backpropagate nothing)
WIDE_LAYER_ELEMS = 16384


def gradient_sample(name: str, n: int, kernel_size: int = 1) -> np.ndarray:
    """A deterministic layer-shaped gradient stand-in: a Gaussian body at
    1/sqrt(kernel_size), 1 % of it 8x larger, and half of it (90 % for wide
    layers) exactly zero; seeded by crc32 of the request name, so every
    process derives the same table with no collective."""
    m = min(int(n), SAMPLE_CAP)
    rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF)
    scale = 1.0 / float(np.sqrt(max(1, kernel_size)))
    x = rng.normal(0.0, scale, size=m).astype(np.float32)
    spikes = rng.random(m) < 0.01
    x[spikes] *= 8.0
    sparsity = 0.9 if n >= WIDE_LAYER_ELEMS else 0.5
    x[rng.random(m) < sparsity] = 0.0
    return x


def norm_spectrum(x: np.ndarray) -> dict:
    """The norm statistics the profile keeps beside the NSR."""
    ax = np.abs(x)
    return {
        "l2": float(np.linalg.norm(x)),
        "linf": float(ax.max(initial=0.0)),
        "mean_abs": float(ax.mean()) if x.size else 0.0,
        # the share of the l1 norm the top 1 % of elements carry
        "top1pct_mass": float(
            np.sort(ax)[::-1][: max(1, x.size // 100)].sum() / max(ax.sum(), 1e-30)),
    }


def measure_nsr(codec, x: np.ndarray, device=None) -> float:
    """Noise-to-signal power of one encode/decode round trip of ``x``, the
    codec run on ``device`` (the CPU when None), the powers in float64."""
    n = int(x.shape[0])
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    if device is not None:
        xt = xt.to(device)
    xhat = codec.decode(codec.encode(xt), n).cpu().numpy()
    sig = float(np.sum(np.square(x, dtype=np.float64)))
    if sig == 0.0:
        return 0.0
    return float(np.sum(np.square((xhat - x).astype(np.float64)))) / sig


def candidate_cells(config, name: str, n: int, x: np.ndarray, device=None) -> List[dict]:
    """A set's search space, each cell with its measured NSR and the wire
    bytes of the full payload that the solver ranks on."""
    from mlsl_tpu_torch import codecs as codecs_mod
    from mlsl_tpu_torch.codecs import vq as vq_mod

    cells: List[dict] = []

    def add(codec_name: str, codec, block: int = 0, params: Optional[dict] = None):
        cells.append({"codec": codec_name, "block": int(block), "params": params or {},
                      "nsr": measure_nsr(codec, x, device),
                      "wire_bytes": int(codec.wire_len(n))})

    session_block = int(getattr(config, "quant_block_elems", 256) or 256)
    for block in sorted({*INT8_BLOCKS, session_block}):
        add("int8", codecs_mod.get("int8", block=block), block=block)
    for ratio in PRUNE_RATIOS:
        add("prune", codecs_mod.get("prune", ratio=ratio), params={"ratio": float(ratio)})
    k = int(getattr(config, "vq_codebook", 16) or 16)
    for dim in VQ_DIMS:
        cb = vq_mod.learn_codebook(x, k=k, dim=dim)
        add("vq", codecs_mod.get("vq", dim=dim, k=k, codebook=cb),
            params={"vq_dim": int(dim), "vq_codebook": k, "codebook": cb.tolist()})
    return cells


def solve(cells: List[dict], budget: float) -> Optional[dict]:
    """The cheapest cell within the NSR budget, int8 first among equals;
    None when none fits (the set keeps its uncalibrated codec)."""
    fits = [c for c in cells if c["nsr"] <= budget]
    if not fits:
        return None
    return min(fits, key=lambda c: (c["wire_bytes"], c["codec"] != "int8"))


def calibrate_session(session) -> Dict[str, dict]:
    """The Session.commit hook: measure, solve, persist, apply. -> the table
    (request name -> cell)."""
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.types import CompressionType

    env = session.env
    cfg = env.config
    budget = float(cfg.codec_nsr_budget)
    table: Dict[str, dict] = {}
    targets: List[Tuple[str, object]] = []
    for op in session.operations:
        for ps in op.parameter_sets:
            req = ps.grad_req
            if req is None or req.desc.compression != CompressionType.QUANTIZATION:
                continue
            n = int(req.desc.count)
            x = gradient_sample(req.name, n, ps.kernel_size)
            cell = solve(candidate_cells(cfg, req.name, n, x, env.device), budget)
            if cell is None:
                log_warning("codec calibration: no codec meets NSR budget %.4g for %s; "
                            "keeping the uncalibrated default", budget, req.name)
                continue
            table[req.name] = dict(cell, spectrum=norm_spectrum(x))
            targets.append((req.name, req))
    stats_mod.record_codec("calibrations")
    if not table:
        return table
    _persist(cfg, table, env.world_size, env.device)
    if "codec" in (getattr(cfg, "_explicit", ()) or ()):
        # an exported MLSL_CODEC wins; the profile keeps the measurement
        log_info("codec calibration: %d cell(s) measured but MLSL_CODEC=%s is exported; "
                 "live assignment unchanged", len(table), cfg.codec)
        return table
    cfg.codec_assignment = dict(table)
    for _, req in targets:
        req.setup()          # re-route onto the calibrated codec
        stats_mod.record_codec("assignments")
    log_info("codec calibration: %d set(s) assigned under NSR budget %.4g (%s)", len(table),
             budget, ", ".join(f"{k}->{v['codec']}" for k, v in sorted(table.items())))
    return table


def _persist(cfg, table: Dict[str, dict], world_size: int, device) -> None:
    """Merge the table into the topology-keyed profile: made when absent,
    rewritten for this topology when stale, saved atomically. The cells keep
    their measurements (NSR, spectrum, codebook)."""
    from mlsl_tpu_torch import sysinfo

    path = cfg.tune_profile or default_profile_path()
    fp = sysinfo.topology_fingerprint(world_size, device)
    try:
        profile = load_profile(path)
    except MLSLError:
        profile = None          # absent or unreadable: a new document
    if profile is not None and not profile.matches(fp):
        log_warning("codec calibration: existing profile %s was measured on a different "
                    "topology; rewriting its codec table for this one", path)
        profile = None
    if profile is None:
        profile = TunedProfile(fingerprint=fp)
    profile.codecs = dict(profile.codecs or {}, **table)
    profile.save(path)
    log_info("codec calibration: %d cell(s) -> %s", len(table), path)
