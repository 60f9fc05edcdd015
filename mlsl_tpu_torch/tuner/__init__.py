"""The autotuner: measured algorithm and knob selection.

Counterpart of ``mlsl_tpu.tuner``. ``init_profile`` runs at Environment.init,
right after ``Config.validate``:

- ``MLSL_TUNE=1``: the sweep (tuner/sweep.py) measures the live world of
  virtual ranks on the Environment's device (``MLSL_TUNE_QUANT=1`` adds the
  int8 cells), writes the profile to ``MLSL_TUNE_PROFILE`` (default
  ``mlsl_tune_profile.json`` in ``MLSL_STATS_DIR`` or the working
  directory), installs it and applies its knobs;
- ``MLSL_TUNE_PROFILE`` alone: the profile is loaded, rejected with a
  warning when its topology fingerprint is not this world's (a profile
  measured on a TPU always is stale here, and one swept on a tiered world
  is stale on a flat one), and otherwise installed on the config, where
  ``comm.algos.select`` consults it, and its knobs applied.

Knobs the user exported win; knobs the port's Config does not have are named
in a warning (entries whose name starts with ``_`` are the sweep's
measurements, not knobs). The profile's codec table becomes
``config.codec_assignment`` unless the user exported ``MLSL_CODEC``. Under
``MLSL_TUNE_CODEC=1`` a named profile that does not exist yet is the
calibration's to write (tuner/calibrate.py), not an error.
"""

from __future__ import annotations

import os

from mlsl_tpu_torch.log import log_info, log_warning
from mlsl_tpu_torch.tuner.profile import (  # noqa: F401  (public API)
    DEFAULT_PROFILE_FILE,
    KNOB_CHOICES,
    KNOB_RANGES,
    TunedProfile,
    default_profile_path,
    load_profile,
)
from mlsl_tpu_torch.tuner.sweep import run_sweep  # noqa: F401

#: the Config fields a profile's knob table may set, ranges and choices
#: checked at load
TUNABLE_KNOBS = tuple(KNOB_RANGES) + tuple(KNOB_CHOICES)


def apply_knobs(config, profile: TunedProfile) -> None:
    """Apply a profile's knobs to ``config``, except those the user exported
    (``Config._explicit``) and those the port's Config does not have."""
    explicit = getattr(config, "_explicit", set())
    missing = []
    for name, value in profile.knobs.items():
        if name.startswith("_"):
            continue            # the sweep's measurements
        if name not in TUNABLE_KNOBS:
            missing.append(name)
        elif name not in explicit:
            setattr(config, name, value)
    if missing:
        log_warning("tuner: profile knobs %s have no counterpart in this package; "
                    "not applied", ", ".join(sorted(missing)))
    # the calibrated per-request codecs, unless an exported MLSL_CODEC pins
    # every set to one codec
    if profile.codecs and "codec" not in explicit:
        config.codec_assignment = dict(profile.codecs)


def init_profile(config, world_size: int, device) -> None:
    """Environment.init hook: resolve the tuned profile for this world."""
    from mlsl_tpu_torch import sysinfo

    config.tuned_profile = None
    if config.tune:
        path = config.tune_profile or default_profile_path()
        # MLSL_TUNE_QUANT=1 adds the int8 cells (the JAX package's opt-in)
        quant = os.environ.get("MLSL_TUNE_QUANT", "").strip().lower() not in (
            "", "0", "false", "no", "off")
        profile = run_sweep(world_size, device, quant=quant, config=config)
        profile.save(path)
        log_info("tuner: profile written to %s (%d cells)", path, len(profile.cells))
        config.tuned_profile = profile
        apply_knobs(config, profile)
        return
    if not config.tune_profile:
        return
    if config.tune_codec and not os.path.exists(config.tune_profile):
        log_info("tuner: profile %s absent; the codec calibration writes it at commit",
                 config.tune_profile)
        return
    profile = load_profile(config.tune_profile)      # MLSLError on a bad file
    fp = sysinfo.topology_fingerprint(world_size, device)
    if not profile.matches(fp):
        log_warning("tuner: profile %s was measured on a different topology (profile %r "
                    "vs this world %r); rejecting it", config.tune_profile,
                    profile.fingerprint, fp)
        return
    config.tuned_profile = profile
    apply_knobs(config, profile)
