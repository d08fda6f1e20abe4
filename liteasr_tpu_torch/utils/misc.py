"""Misc helpers (reference: liteasr/utils/utils.py:6-17)."""

from typing import Tuple


def dec2hex(decimal: int) -> Tuple[str, str, str]:
    """Shard-path codec for memory_save batch dumps.

    >>> dec2hex(10)
    ('00', '00', '00a')
    >>> dec2hex(100000)
    ('00', '18', '6a0')
    """
    hexadecimal = "{:0>7x}".format(decimal)
    return hexadecimal[:2], hexadecimal[2:4], hexadecimal[4:7]


def round_up(value: int, multiple: int) -> int:
    if multiple <= 1:
        return value
    return ((value + multiple - 1) // multiple) * multiple
