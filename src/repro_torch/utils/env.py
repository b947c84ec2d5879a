"""Validated ``REPRO_*`` environment parsing for the PyTorch port.

The port keeps its own copy of the reference package's ``repro.utils.env`` (it
imports nothing of that package): every knob it reads from the environment
goes through here, so a typo'd value fails loudly, naming the variable, instead
of silently falling back. ``REPRO_RNG_ROUNDS`` (the Gaussian threefry round
count, passed to the CUDA kernels as an argument) is the knob this slice reads.

Stdlib-only: it sits below ``repro_torch.kernels.common`` in the import graph.
"""
from __future__ import annotations

import os

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def read_raw(name: str, default: str = "") -> str:
    """The stripped raw value of ``name`` (``default`` when unset)."""
    return os.environ.get(name, default).strip()


def read_bool(name: str, default: bool | None = None) -> bool | None:
    """Tri-state boolean: True/False when set, ``default`` when unset or empty.

    Accepts ``1/true/yes/on`` and ``0/false/no/off`` (case-insensitive); anything
    else raises a ``ValueError`` naming the variable.
    """
    raw = read_raw(name).lower()
    if not raw:
        return default
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    raise ValueError(
        f"{name} must be a boolean flag ({'/'.join(_TRUE)} or {'/'.join(_FALSE)}), got {raw!r}"
    )


def read_int(
    name: str,
    default: int | None = None,
    *,
    positive: bool = False,
    multiple_of: int | None = None,
) -> int | None:
    """Integer knob: parsed value when set, ``default`` when unset or empty.

    A non-integer value, a non-positive value under ``positive=True``, or a value
    that is not a multiple of ``multiple_of`` all raise a ``ValueError`` naming
    the variable and the constraint.
    """
    raw = read_raw(name)
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    constraint = None
    if positive and multiple_of is not None:
        constraint = f"a positive multiple of {multiple_of}"
        bad = value <= 0 or value % multiple_of
    elif positive:
        constraint = "a positive integer"
        bad = value <= 0
    elif multiple_of is not None:
        constraint = f"a multiple of {multiple_of}"
        bad = bool(value % multiple_of)
    else:
        bad = False
    if bad:
        raise ValueError(f"{name} must be {constraint}, got {value}")
    return value
