"""Terminal/IO helpers (port of ``manifold_gp_tpu.utils.io``; reference
``utils/iostream.py:1-19``): ANSI color codes for pass/fail reporting and a
small matrix pretty-printer used by script-style checks."""

from __future__ import annotations

import numpy as np

RESET = "\033[0m"
RED = "\033[31m"
GREEN = "\033[32m"
YELLOW = "\033[33m"
BLUE = "\033[34m"
BOLD = "\033[1m"


def green(s: str) -> str:
    return f"{GREEN}{s}{RESET}"


def red(s: str) -> str:
    return f"{RED}{s}{RESET}"


def passfail(ok: bool, label: str) -> str:
    return f"{label}: " + (green("PASSED") if ok else red("FAILED"))


def print_mat(a, name: str = "", decimals: int = 5):
    """Compact fixed-decimal matrix print (reference iostream matrix
    pretty-printer equivalent)."""
    a = np.asarray(a)
    if name:
        print(f"{BOLD}{name}{RESET} shape={a.shape}")
    with np.printoptions(precision=decimals, suppress=True, linewidth=200):
        print(a)
