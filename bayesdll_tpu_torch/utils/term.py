"""Terminal helpers (counterpart of bayesdll_tpu.utils.term; reference
`utils.py:8-40`)."""

import os

_COLORS = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "magenta": 35,
           "cyan": 36, "white": 37}


def mkdir(*paths):
    """Create directories (reference `utils.py:8`)."""
    for p in paths:
        os.makedirs(p, exist_ok=True)


def cprint(color: str, text: str):
    """ANSI-colored print (reference `utils.py:18`)."""
    code = _COLORS.get(color, 37)
    print(f"\033[{code}m{text}\033[0m")
