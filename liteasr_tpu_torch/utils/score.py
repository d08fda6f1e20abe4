"""Levenshtein edit distance (reference: liteasr/utils/score.py:4-22).

The C++ loop of :mod:`liteasr_tpu_torch.native` where its library builds,
else this module's pure-Python version (the native module warns once).
"""

from liteasr_tpu_torch import native


def levenshtein(a, b) -> int:
    out = native.levenshtein(a, b)
    return _levenshtein_py(a, b) if out is None else out


def _levenshtein_py(a, b) -> int:
    n, m = len(a), len(b)
    if n > m:
        a, b = b, a
        n, m = m, n
    curr = list(range(n + 1))
    for i in range(1, m + 1):
        prev, curr = curr, [i] + [0] * n
        for j in range(1, n + 1):
            insert, delete = prev[j] + 1, curr[j - 1] + 1
            change = prev[j - 1] + (a[j - 1] != b[i - 1])
            curr[j] = min(insert, delete, change)
    return curr[n]
