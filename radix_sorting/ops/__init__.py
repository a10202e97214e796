"""Engine building blocks: KDF, probes, histograms, scans, sort engines."""

from . import (  # noqa: F401
    bitmap,
    histogram,
    hw_engine,
    kdf,
    lsd_engine,
    probes,
    scan,
)
