"""Environment flag parsing for the overrides (``FLUTPU_SEGMENTED``).

One convention everywhere: unset → the caller's default; ``0`` / ``false``
/ ``no`` / empty → False; anything else → True — so ``FLAG=0`` can never
enable an arm through string truthiness.
"""

import os
from typing import Optional


def env_flag(name: str, default: Optional[bool] = None) -> Optional[bool]:
    """Tri-state environment flag: None when unset (caller decides),
    else the parsed boolean."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no")
