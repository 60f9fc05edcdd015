"""Tuned profiles: measured algorithm and knob selection, load path.

Counterpart of ``mlsl_tpu.tuner`` without the sweep. ``init_profile`` runs at
Environment.init, right after ``Config.validate``: with ``MLSL_TUNE_PROFILE``
set it loads the profile, rejects it with a warning when its topology
fingerprint is not this world's (a profile measured on a TPU always is
stale here), and otherwise installs it on the config, where
``comm.algos.select`` consults it, and applies its knobs. Knobs the user
exported win; knobs the port's Config does not have are named in a warning.
The profile's codec table becomes ``config.codec_assignment`` unless the user
exported ``MLSL_CODEC``. Under ``MLSL_TUNE_CODEC=1`` a named profile that does
not exist yet is the calibration's to write (tuner/calibrate.py), not an
error. ``MLSL_TUNE=1`` (the sweep) raises MLSLError: not ported yet.
"""

from __future__ import annotations

from mlsl_tpu_torch.log import log_info, log_warning, mlsl_assert
from mlsl_tpu_torch.tuner.profile import (  # noqa: F401  (public API)
    DEFAULT_PROFILE_FILE,
    KNOB_RANGES,
    TunedProfile,
    default_profile_path,
    load_profile,
)


def apply_knobs(config, profile: TunedProfile) -> None:
    """Apply a profile's knobs to ``config``, except those the user exported
    (``Config._explicit``) and those the port's Config does not have
    (``KNOB_RANGES`` lists the ones it has)."""
    explicit = getattr(config, "_explicit", set())
    missing = []
    for name, value in profile.knobs.items():
        if name not in KNOB_RANGES:
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
    mlsl_assert(not config.tune, "MLSL_TUNE=1 (the autotuner's sweep) is not ported yet; "
                "load a measured profile with MLSL_TUNE_PROFILE")
    if not config.tune_profile:
        return
    import os

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
