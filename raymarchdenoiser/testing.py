"""Self-registering, regex-filtered, timed case runner.

Python port of the reference's zero-dependency harness (``include/test.h:9-22``,
``src/test.cu:17-48``): ``@case_`` registers like the ``TEST(name)`` macro,
``skip`` compiles-but-doesn't-register like ``SKIP(name)``, and :func:`run`
regex-matches labels (full-match semantics, default ``.*``), times each case,
and prints ``Passed with X ms`` / ``Fail with <msg>`` exactly in the
reference's format (``src/test.cu:31-46``).  The CLI front end is
``python -m raymarchdenoiser.cli -t [regex]`` (reference main.cpp).
"""

from __future__ import annotations

import re
import time
import traceback
from typing import Callable, Dict, Optional

registered_funcs: Dict[str, Callable[[], None]] = {}


def case_(name: Optional[str] = None):
    """Register a runnable case (reference ``TEST(name)``, test.h:9-16)."""

    def deco(fn):
        registered_funcs[name or fn.__name__] = fn
        return fn

    if callable(name):  # used bare: @case_
        fn, name = name, None
        return deco(fn)
    return deco


def skip(name: Optional[str] = None):
    """Keep the body importable without registering (``SKIP``, test.h:18-19)."""

    def deco(fn):
        return fn

    if callable(name):
        return name
    return deco


def run(wildcard: str = ".*", out=print) -> bool:
    """Run matching cases; True iff all passed (reference test(), test.cu:17-48)."""
    out("Available tests:")
    for label in registered_funcs:
        out(f"\t{label}")
    pattern = re.compile(wildcard)
    ok = True
    for label, fn in registered_funcs.items():
        if not pattern.fullmatch(label):
            continue
        out(f"Running test {label}")
        t0 = time.perf_counter()
        try:
            fn()
            ms = (time.perf_counter() - t0) * 1e3
            out(f"\tPassed with {ms:.3f} ms")
        except Exception as e:  # noqa: BLE001 - runner must survive any case
            ok = False
            out(f"\tFail with {e}")
            traceback.print_exc()
    return ok
