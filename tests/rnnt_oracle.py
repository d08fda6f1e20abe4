"""The brute-force transducer oracle that the RNN-T loss's tests hold the
port against, without JAX (so that the card's tests can import it)."""

import numpy as np


def oracle_rnnt(logp: np.ndarray, target: np.ndarray, T: int, U: int) -> float:
    """The transducer forward algorithm cell by cell over (T, U+1), in fp64
    (the idea of tests/test_rnnt.py's oracle). logp: (Tmax, Umax+1, V)."""
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + logp[t - 1, u, 0])
            if u > 0:
                cands.append(alpha[t, u - 1] + logp[t, u - 1, target[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[T - 1, U] + logp[T - 1, U, 0])
