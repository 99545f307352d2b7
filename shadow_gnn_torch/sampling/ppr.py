"""Approximate personalized PageRank precompute + top-k tables (host).

* :func:`ppr_push_host` — the reference's lazy forward push, in the
  native C++ library (``native/``) or, only when the caller asks with
  ``use_native=False``, in pure Python;
* :func:`ppr_topk_tables` — per-target lists -> dense [T, k] tables;
* a binary cache byte-compatible with the reference's
  ``ppr_float/{neighs,scores}_*.bin`` files, so tables computed by
  either package (or the reference) are reused by the other.

Semantics (as in the reference C++):
* config ``alpha`` is flipped internally: ``alpha_int = 1 - alpha``;
* the push is lazy: on settling, half of ``(1-alpha_int)*res`` stays at
  the node;
* top-k sorts by (-score, node id), so ties break by id.
"""
from __future__ import annotations

import heapq
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# host forward-push (reference semantics)
# ---------------------------------------------------------------------------

def ppr_push_single(indptr: np.ndarray, indices: np.ndarray, deg: np.ndarray,
                    target: int, alpha_int: float, epsilon: float
                    ) -> Dict[int, float]:
    """Forward-push approximate PPR from one target: {node: pi} for every
    node that settled.  The frontier pops the smallest id first."""
    pi = {}
    residue = {target: 1.0}
    prop = [target]
    in_prop = {target}
    touched = {}
    while prop:
        v = heapq.heappop(prop)
        in_prop.discard(v)
        res = residue.get(v, 0.0)
        pi[v] = pi.get(v, 0.0) + alpha_int * res
        dv = deg[v]
        if dv > 0:
            m = (1.0 - alpha_int) * res / (2.0 * dv)
            for u in indices[indptr[v]:indptr[v + 1]]:
                u = int(u)
                residue[u] = residue.get(u, 0.0) + m
                if residue[u] > epsilon * deg[u] and u not in in_prop:
                    heapq.heappush(prop, u)
                    in_prop.add(u)
        residue[v] = res * (1.0 - alpha_int) / 2.0
        if residue[v] <= epsilon * dv or dv == 0:
            touched[v] = pi[v]
        elif v not in in_prop:
            heapq.heappush(prop, v)
            in_prop.add(v)
    return touched


def _topk_sorted(touched: Dict[int, float], k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k by score, ties broken by smaller node id; sorted descending."""
    if not touched:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    ids = np.fromiter(touched.keys(), dtype=np.int64)
    sc = np.fromiter(touched.values(), dtype=np.float64)
    order = np.lexsort((ids, -sc))[: min(k, ids.size)]
    return ids[order].astype(np.int32), sc[order].astype(np.float32)


def ppr_push_host(indptr: np.ndarray, indices: np.ndarray,
                  targets: np.ndarray, k: int, alpha: float, epsilon: float,
                  use_native: bool = True) -> Tuple[list, list]:
    """Per-target approximate PPR; returns (neighs_list, scores_list).

    ``alpha`` is the config alpha (e.g. 0.85), flipped internally.  The
    native library is the default and a failure to build or load it
    raises; the pure-Python push (float64 arithmetic, so its scores
    differ from the native float32 ones in the last digits) runs only
    with ``use_native=False``.
    """
    alpha_int = 1.0 - alpha
    if use_native:
        from shadow_gnn_torch.native import ppr_push_native
        return ppr_push_native(indptr, indices, targets, k, alpha_int, epsilon)
    deg = np.diff(indptr).astype(np.int64)
    neighs, scores = [], []
    for t in np.asarray(targets):
        touched = ppr_push_single(indptr, indices, deg, int(t), alpha_int, epsilon)
        ni, si = _topk_sorted(touched, k)
        neighs.append(ni)
        scores.append(si)
    return neighs, scores


def ppr_topk_tables(neighs, scores, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-target lists into dense [T, k] tables (pad: id=-1, score=0)."""
    t = len(neighs)
    tab_n = np.full((t, k), -1, dtype=np.int32)
    tab_s = np.zeros((t, k), dtype=np.float32)
    for i, (ni, si) in enumerate(zip(neighs, scores)):
        m = min(k, ni.size)
        tab_n[i, :m] = ni[:m]
        tab_s[i, :m] = si[:m]
    return tab_n, tab_s


# ---------------------------------------------------------------------------
# binary cache, byte-compatible with the reference
# ---------------------------------------------------------------------------

def _trans_tag(is_transductive: bool, variant: str) -> str:
    tag = "transductive" if is_transductive else "inductive"
    return f"{tag}-{variant}" if variant else tag


def ppr_cache_paths(dir_data: str, name_data: str, is_transductive: bool,
                    mode_str: str, alpha: float, epsilon: float, k: int,
                    variant: str = ""):
    """File naming contract of the reference (samplers_cpp.py:135-170)."""
    d = f"{dir_data}/{name_data}/ppr_float"
    suffix = f"{_trans_tag(is_transductive, variant)}_{mode_str}_{alpha}_{epsilon}"
    return (f"{d}/neighs_{suffix}_{k}.bin", f"{d}/scores_{suffix}_{k}.bin")


def find_ppr_cache(dir_data: str, name_data: str, is_transductive: bool,
                   mode_str: str, alpha: float, epsilon: float,
                   k_required: int, variant: str = ""):
    """Any cached file pair with k_meta >= k_required, else (None, None)."""
    import glob as _glob
    d = f"{dir_data}/{name_data}/ppr_float"
    suffix = f"{_trans_tag(is_transductive, variant)}_{mode_str}_{alpha}_{epsilon}"
    for cn in sorted(_glob.glob(f"{d}/neighs_{suffix}_*")):
        k_meta = int(cn.rsplit("_", 1)[-1].split(".bin")[0])
        cs = f"{d}/scores_{suffix}_{k_meta}.bin"
        if k_meta >= k_required and os.path.isfile(cs):
            return cn, cs
    return None, None


def _write_ragged_vec(path: str, lengths: np.ndarray, payload: np.ndarray,
                      k: int, alpha_int: float, epsilon: float):
    """Write the whole ragged file as one u32 word buffer: header, then
    per row a length word followed by its payload."""
    lengths = np.asarray(lengths, dtype=np.int64)
    cnt = lengths.size
    total_words = 4 + cnt + int(lengths.sum())
    arr = np.zeros(total_words, dtype="<u4")
    arr[:4] = np.frombuffer(struct.pack("<ffiI", alpha_int, epsilon, k, cnt), "<u4")
    pos = 4 + np.arange(cnt, dtype=np.int64)
    pos[1:] += np.cumsum(lengths[:-1])
    arr[pos] = lengths.astype("<u4")
    mask = np.ones(total_words, bool)
    mask[:4] = False
    mask[pos] = False
    arr[mask] = np.ascontiguousarray(payload).view("<u4")
    arr.tofile(path)


def _ragged_payloads(target_rows: np.ndarray, num_nodes: int, neighs, scores):
    """(lengths[num_nodes], neighs payload, scores payload) in node-id
    row order, from per-target ragged lists."""
    targets = np.asarray(target_rows, dtype=np.int64)
    order = np.argsort(targets, kind="stable")
    lengths = np.zeros(num_nodes, np.int64)
    lengths[targets] = np.fromiter((len(v) for v in neighs), np.int64,
                                   count=len(neighs))
    if not len(neighs):
        return lengths, np.zeros(0, "<u4"), np.zeros(0, "<f4")
    n_pay = np.concatenate([np.asarray(neighs[i]) for i in order]).astype("<u4")
    s_pay = np.concatenate([np.asarray(scores[i]) for i in order]).astype("<f4")
    return lengths, n_pay, s_pay


def write_ppr_cache(fname_neighs: str, fname_scores: str, num_nodes: int,
                    target_rows: np.ndarray, neighs, scores,
                    k: int, alpha_config: float, epsilon: float):
    """Write the reference bin format; non-target rows get empty lists.
    The header stores the internal alpha (1 - config alpha)."""
    os.makedirs(os.path.dirname(fname_neighs), exist_ok=True)
    alpha_int = 1.0 - alpha_config
    lengths, n_pay, s_pay = _ragged_payloads(target_rows, num_nodes, neighs, scores)
    _write_ragged_vec(fname_neighs, lengths, n_pay, k, alpha_int, epsilon)
    _write_ragged_vec(fname_scores, lengths, s_pay, k, alpha_int, epsilon)


class RaggedRows:
    """View over one ragged bin file: row i is ``buf[pos[i]+1 :
    pos[i]+1+len_i]`` viewed as ``dtype``, clipped to k."""

    def __init__(self, buf: np.ndarray, pos: np.ndarray,
                 lengths: np.ndarray, k: int, dtype: str):
        self._buf = buf
        self._pos = pos
        self.lengths = lengths
        self.k = k
        self.dtype = dtype

    def __len__(self):
        return self._pos.size

    def __getitem__(self, i: int) -> np.ndarray:
        n = min(int(self.lengths[i]), self.k)
        p = int(self._pos[i]) + 1
        return self._buf[p:p + n].view(self.dtype)


def read_ppr_cache(fname_neighs: str, fname_scores: str, k: int,
                   alpha_config: float, epsilon: float
                   ) -> Optional[Tuple[RaggedRows, RaggedRows]]:
    """Read the bin cache pair; None when absent or on a meta mismatch."""
    if not (os.path.isfile(fname_neighs) and os.path.isfile(fname_scores)):
        return None
    from shadow_gnn_torch.native import ragged_offsets
    alpha_int = 1.0 - alpha_config

    def read_file(path, np_dtype):
        buf = np.fromfile(path, dtype="<u4")
        a, e, k_, cnt = struct.unpack("<ffiI", buf[:4].tobytes())
        if abs(a - np.float32(alpha_int)) > 1e-7 or e > 1.1 * epsilon \
                or e < 0.9 * epsilon or k_ < k:
            return None
        pos = ragged_offsets(buf, cnt)
        return RaggedRows(buf, pos, buf[pos].astype(np.int64), k, np_dtype)

    nv = read_file(fname_neighs, "<i4")
    if nv is None:
        return None
    sv = read_file(fname_scores, "<f4")
    if sv is None:
        return None
    return nv, sv
