"""Model configurations ported from ``repro.configs``."""
