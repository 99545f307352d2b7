"""Inputs of a cell from its seed: the graph, features, labels, splits
and the model's weights.

Everything is drawn on the run's device from one ``torch.Generator``,
in a few large calls, so that the same seed gives the same arrays on
any card (and, drawn on the CPU, in the tests).  The shapes are the
configuration's own and never depend on the seed: a graph has exactly
``num_edges`` directed edges (``num_edges / 2`` undirected pairs, no
self loops), and the splits exactly the configured sizes.  A
configuration's ``degree_exponent`` of 0 draws each pair's endpoints
uniformly; above 0 with weights ``rank ** -degree_exponent`` (the
Chung-Lu model of a power law, the repo's
``make_random_graph(power_law=True)`` rule), ranks placed at random
ids.  Both the program and the reference are handed these arrays.

A ``data`` block holds ``num_nodes``, ``num_edges`` (directed: both
directions of each pair), ``num_feat``, ``num_classes``,
``degree_exponent`` and ``transductive``, and by its task:

* ``task`` absent or ``"node"``: ``split``, the TRAIN / VALID / TEST
  node counts, which add up to ``num_nodes``;
* ``task`` ``"link"`` (transductive only; no ``split``): ``edge_split``,
  the TRAIN / VALID / TEST positive pairs, and ``eval_negatives``, the
  negative pairs of VALID and of TEST each.  The TRAIN positives are
  pairs of the graph (all of them where ``edge_split[0]`` is
  ``num_edges / 2``); the VALID and TEST positives are pairs outside
  the graph whose endpoints are drawn in proportion to their degree in
  it, distinct across both modes; the negatives are uniform pairs, no
  self loops, neither edges of the graph nor positives of any mode.

The graph, features and labels are drawn from stream 1 of the seed and
the weights from stream 2, alike for both tasks; every array of the
link task from stream 3, so that its draws move nothing of a node
configuration's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TRAIN, VALID, TEST = 0, 1, 2


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % 2**63)


def _endpoints(n: int, exponent: float, gen: torch.Generator, device):
    """``draw(k)`` -> [2, k] endpoint ids of ``n`` nodes: uniform where
    ``exponent`` is 0, else each drawn with weight ``rank **
    -exponent``, the ranks placed at random ids."""
    draw = lambda k: torch.randint(0, n, (2, k), generator=gen, device=device)
    if exponent:
        cdf = torch.cumsum(torch.arange(1, n + 1, device=device, dtype=torch.float64)
                           .pow_(-exponent), 0)
        cdf /= cdf[-1].clone()
        place = torch.randperm(n, generator=gen, device=device)

        def draw(k):
            u = torch.rand(2 * k, generator=gen, device=device, dtype=torch.float64)
            return place[torch.clamp(torch.searchsorted(cdf, u), max=n - 1)].view(2, k)
    return draw


def _distinct(n: int, m: int, draw, gen: torch.Generator, device,
              exclude: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``m`` distinct undirected pairs u < v of ``n`` nodes, endpoints
    from ``draw``, none of them a key of ``exclude``, as sorted int64
    keys u * n + v."""
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < m:
        uv = draw(int((m - keys.numel()) * 1.05) + 1024)
        lo, hi = torch.minimum(uv[0], uv[1]), torch.maximum(uv[0], uv[1])
        new = (lo * n + hi)[lo != hi]
        if exclude is not None:
            new = new[~torch.isin(new, exclude)]
        keys = torch.unique(torch.cat([keys, new]))
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:m]
    return torch.sort(keys[pick])[0]


def _csr(row: torch.Tensor, col: torch.Tensor, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host CSR (int64 indptr, int32 indices; each row ascending)."""
    order = torch.argsort(row * n + col)
    row, col = row[order], col[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return indptr.cpu().numpy(), col.to(torch.int32).cpu().numpy()


def _split_keys(keys: torch.Tensor, first: int, gen: torch.Generator):
    """``keys`` split at random into sorted parts of ``first`` and the rest."""
    order = torch.randperm(keys.numel(), generator=gen, device=keys.device)
    return torch.sort(keys[order[:first]])[0], torch.sort(keys[order[first:]])[0]


def _edge_set(data: Dict, keys: torch.Tensor, col: torch.Tensor, seed: int,
              device) -> Dict[int, Dict[str, np.ndarray]]:
    """The link task's splits, {mode: {"pos": [m, 2] int64, "neg": ...}}
    (TRAIN has no "neg": the program draws its negatives), from the
    graph's sorted pair keys ``keys`` and its directed edges' heads
    ``col``, on stream 3 of ``seed``."""
    n = data["num_nodes"]
    n_tr, n_va, n_te = data["edge_split"]
    q = int(data["eval_negatives"])
    if n_tr > keys.numel():
        raise ValueError(f"edge_split asks for {n_tr} TRAIN pairs of a graph of "
                         f"{keys.numel()}")
    g = generator(seed, device, 3)
    train = keys[torch.sort(torch.randperm(keys.numel(), generator=g, device=device)[:n_tr])[0]]
    by_degree = lambda k: col[torch.randint(0, col.numel(), (2, k), generator=g, device=device)]
    held = _distinct(n, n_va + n_te, by_degree, g, device, exclude=keys)
    uniform = lambda k: torch.randint(0, n, (2, k), generator=g, device=device)
    neg = _distinct(n, 2 * q, uniform, g, device,
                    exclude=torch.sort(torch.cat([keys, held]))[0])
    (va, te), (neg_va, neg_te) = _split_keys(held, n_va, g), _split_keys(neg, q, g)
    pairs = lambda k: torch.stack([k // n, k % n], 1).cpu().numpy()
    return {TRAIN: {"pos": pairs(train)},
            VALID: {"pos": pairs(va), "neg": pairs(neg_va)},
            TEST: {"pos": pairs(te), "neg": pairs(neg_te)}}


def make_dataset(data: Dict, seed: int, device) -> Dict:
    """The cell's data from ``data`` (the configuration's ``data``
    block, the module's docstring) and ``seed``: ``indptr`` /
    ``indices`` of the full graph, ``indptr_train`` / ``indices_train``
    of the TRAIN graph (None when ``transductive``: the graph of
    TRAIN-TRAIN edges, over all node ids, otherwise), ``feat`` [n, F]
    f32, ``label`` [n] int64, and by the task ``node_set`` {mode: sorted
    ids} (None for the link task) and ``edge_set`` (None for the node
    task: :func:`_edge_set`); all numpy.  Features carry a planted class
    signal under unit noise (the link task reads no labels)."""
    n, m, f = data["num_nodes"], data["num_edges"], data["num_feat"]
    c = data["num_classes"]
    link = data.get("task", "node") == "link"
    if m % 2:
        raise ValueError("num_edges counts both directions of each pair: even")
    if link and not data["transductive"]:
        raise ValueError("the link task's data block is transductive")
    g = generator(seed, device, 1)
    keys = _distinct(n, m // 2, _endpoints(n, float(data["degree_exponent"]), g, device),
                     g, device)
    u, v = keys // n, keys % n
    row, col = torch.cat([u, v]), torch.cat([v, u])
    indptr, indices = _csr(row, col, n)
    perm = torch.randperm(n, generator=g, device=device)
    node_set = indptr_train = indices_train = None
    if not link:
        n_tr, n_va, n_te = data["split"]
        if n_tr + n_va + n_te != n:
            raise ValueError(f"split {data['split']} does not add up to {n} nodes")
        sets = {TRAIN: perm[:n_tr], VALID: perm[n_tr:n_tr + n_va], TEST: perm[n_tr + n_va:]}
        node_set = {md: torch.sort(s)[0].cpu().numpy() for md, s in sets.items()}
        if not data["transductive"]:
            is_tr = torch.zeros(n, dtype=torch.bool, device=device)
            is_tr[sets[TRAIN]] = True
            keep = is_tr[row] & is_tr[col]
            indptr_train, indices_train = _csr(row[keep], col[keep], n)
    label = torch.randint(0, c, (n,), generator=g, device=device)
    centers = torch.randn(c, f, generator=g, device=device)
    feat = torch.randn(n, f, generator=g, device=device).add_(0.5 * centers[label])
    return {"indptr": indptr, "indices": indices, "indptr_train": indptr_train,
            "indices_train": indices_train, "feat": feat.cpu().numpy(),
            "label": label.cpu().numpy(), "node_set": node_set,
            "edge_set": _edge_set(data, keys, col, seed, device) if link else None}


def make_weights(specs: List[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """f32 weights from ``specs`` [(name, shape, init)]: ``init``
    "linear" is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in the
    shape's last axis (or, for a bias, the ``fan_in`` that follows a
    colon: "linear:500"), "glorot" glorot-uniform over the last two
    axes, "ones" / "zeros" / "const:<x>" constants.  One uniform draw
    on ``device`` serves every random leaf."""
    g = generator(seed, device, 2)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (name, shape, init), size in zip(specs, sizes):
        u = flat[at:at + size].view(shape)
        at += size
        kind, _, arg = init.partition(":")
        if kind == "linear":
            fan_in = int(arg) if arg else shape[-1]
            out[name] = u * (1.0 / math.sqrt(fan_in))
        elif kind == "glorot":
            field = math.prod(shape[:-2])
            out[name] = u * math.sqrt(6.0 / (shape[-2] * field + shape[-1] * field))
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "const":
            out[name] = torch.full(shape, float(arg), device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
