"""ANSI-coloured console status lines (copy of the JAX ``utils/term.py``): plain text
unless standard output is a terminal or ``FORCE_COLOR`` is set."""

from __future__ import annotations

import os
import sys

_CODES = {"cyan": "36", "green": "32", "yellow": "33", "red": "31"}


def color(name: str, text: str) -> str:
    if not sys.stdout.isatty() and not os.environ.get("FORCE_COLOR"):
        return text
    return f"\033[{_CODES[name]}m{text}\033[0m"


def cyan(text: str) -> str:
    return color("cyan", text)


def green(text: str) -> str:
    return color("green", text)


def yellow(text: str) -> str:
    return color("yellow", text)
