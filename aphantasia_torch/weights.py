"""Weight resolution and loud random-init warnings (counterpart of
aphantasia_tpu.weights).

There is no network to download checkpoints from, so loaders fall back to
random weights, which makes the imagery meaningless; every fallback says
so once per process.  A weight path can come from a flag or from the
component's environment variable.
"""
from __future__ import annotations

import os
import sys

ENV_VARS = {"clip": "APHANTASIA_CLIP_PT", "aesthetic": "APHANTASIA_AEST_PT",
            "lpips": "APHANTASIA_LPIPS_PT", "dav2": "APHANTASIA_DAV2_PT"}

_warned: set = set()


def env_weights(component: str, path: str | None = None) -> str | None:
    """Explicit path if given, else the component's env var, else None."""
    if path:
        return path
    var = ENV_VARS.get(component)
    return os.environ.get(var) if var else None


def warn_random(component: str) -> None:
    """One banner per component per process (APHANTASIA_QUIET silences)."""
    if component in _warned or os.environ.get("APHANTASIA_QUIET"):
        return
    _warned.add(component)
    var = ENV_VARS.get(component.split()[0].lower(), "")
    hint = f" (set {var} or the matching --*_weights flag)" if var else ""
    print(f"\n{'!' * 74}\n"
          f"!! {component} is RANDOM-INITIALIZED: no checkpoint was found"
          f"{hint}.\n"
          f"!! Generated imagery is meaningless noise until real weights\n"
          f"!! are provided.\n{'!' * 74}", file=sys.stderr)
