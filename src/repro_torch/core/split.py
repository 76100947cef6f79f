"""Split gain and global split finding (paper eqs 6-7, 18-20, Algorithms 2/6).

All candidate splits -- guest plaintext ones and decrypted host ones -- are
reduced to flat arrays of (g_l, h_l, count_l) per candidate, evaluated
vectorized, and the arg-max returned.  MO trees use vector-valued g/h with
the diagonal-Hessian score (eq 19).

The port keeps its own copy of the JAX package's ``core/split.py``,
unchanged: this is numpy work on the host in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..analysis.registry import declassifies


@dataclasses.dataclass
class SplitCandidates:
    """Flat candidate set for one node from one party."""
    party: int                    # -1 = guest, k >= 0 = host k
    sid: np.ndarray               # (m,) split ids (host: shuffled ids)
    g_l: np.ndarray               # (m,) or (m, l) left-side gradient sums
    h_l: np.ndarray               # (m,) or (m, l)
    cnt_l: np.ndarray             # (m,) left-side instance counts


@dataclasses.dataclass
class BestSplit:
    party: int
    sid: int
    gain: float
    g_l: np.ndarray
    h_l: np.ndarray
    cnt_l: int


@declassifies("aggregate leaf statistic: part of the model the protocol "
              "discloses to every party by design")
def leaf_weight(G, H, lam: float, learning_rate: float = 1.0):
    """eq 7 / eq 18 (vector form), scaled by the learning rate."""
    return -learning_rate * np.asarray(G) / (np.asarray(H) + lam)


def _score(G, H, lam):
    """-1/2 * sum_j G_j^2 / (H_j + lam); scalar case is eq 6's per-side term."""
    G = np.asarray(G, np.float64)
    H = np.asarray(H, np.float64)
    s = (G * G) / (H + lam)
    return s if s.ndim <= 1 else s.sum(axis=-1)


def split_gains(g_l, h_l, G_tot, H_tot, lam: float):
    """Vectorized gain (eq 6; eq 19-20 for vector g/h): (m,) float64."""
    g_l = np.asarray(g_l, np.float64)
    h_l = np.asarray(h_l, np.float64)
    g_r = np.asarray(G_tot) - g_l
    h_r = np.asarray(H_tot) - h_l

    def term(G, H):
        s = (G * G) / (H + lam)
        return s.sum(axis=-1) if s.ndim > 1 else s

    parent = np.asarray(G_tot, np.float64) ** 2 / (np.asarray(H_tot) + lam)
    parent = parent.sum() if parent.ndim else float(parent)
    return 0.5 * (term(g_l, h_l) + term(g_r, h_r) - parent)


@declassifies("the split decision (gain arg-max) the protocol reveals to "
              "every party by design")
def find_best_split(cands: list[SplitCandidates], G_tot, H_tot, n_tot: int,
                    lam: float, min_leaf: int = 1,
                    min_gain: float = 1e-6) -> BestSplit | None:
    best = None
    for c in cands:
        if len(c.sid) == 0:
            continue
        gains = split_gains(c.g_l, c.h_l, G_tot, H_tot, lam)
        cnt_r = n_tot - c.cnt_l
        valid = (c.cnt_l >= min_leaf) & (cnt_r >= min_leaf)
        gains = np.where(valid, gains, -np.inf)
        i = int(np.argmax(gains))
        if gains[i] > (best.gain if best else min_gain):
            best = BestSplit(party=c.party, sid=int(c.sid[i]),
                             gain=float(gains[i]),
                             g_l=np.asarray(c.g_l)[i],
                             h_l=np.asarray(c.h_l)[i],
                             cnt_l=int(c.cnt_l[i]))
    return best


def candidates_from_cumsum(G_cum, H_cum, C_cum, party: int) -> SplitCandidates:
    """Flatten (n_f, n_b[, l]) cumulative histograms into candidates.

    Split id encodes (fid, bid): sid = fid * n_b + bid; the last bin of each
    feature is excluded (empty right side).  For host parties the caller
    shuffles sids before sending to the guest.
    """
    n_f, n_b = G_cum.shape[:2]
    fid, bid = np.meshgrid(np.arange(n_f), np.arange(n_b - 1), indexing="ij")
    sid = (fid * n_b + bid).reshape(-1)
    g_l = G_cum[:, : n_b - 1].reshape((-1,) + G_cum.shape[2:])
    h_l = H_cum[:, : n_b - 1].reshape((-1,) + H_cum.shape[2:])
    c_l = C_cum[:, : n_b - 1].reshape(-1)
    return SplitCandidates(party=party, sid=sid, g_l=g_l, h_l=h_l, cnt_l=c_l)


def decode_sid(sid: int, n_b: int) -> tuple[int, int]:
    return sid // n_b, sid % n_b
