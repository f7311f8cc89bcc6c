"""Tagged console logging (port of slam/logging_utils.py)."""

from __future__ import annotations

_STYLES = {
    "MonoGS": "\033[95m",   # magenta
    "GUI": "\033[94m",      # blue
    "Eval": "\033[92m",     # green
    "Backend": "\033[96m",  # cyan
    "Frontend": "\033[93m",  # yellow
}
_RESET = "\033[0m"


def Log(*args, tag: str = "MonoGS"):
    style = _STYLES.get(tag, "")
    print(f"{style}[{tag}]{_RESET}", *args)
