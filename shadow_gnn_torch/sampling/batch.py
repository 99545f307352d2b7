"""Fixed-capacity subgraph batch containers + entity encodings.

Each root's subgraph is a padded block: a batch is ``[B, N]`` node
tables and ``[B, N, N]`` dense adjacency blocks (or, from the cache,
``[B, N, ceil(N/8)]`` packed adjacency bits).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class SubgraphBatch:
    """One batch of B padded subgraphs (tensors on one device).

    nodes      [B, N] int64  global node ids, sorted ascending; padding
                             slots hold ``num_nodes`` (sorts last)
    node_mask  [B, N] bool
    adj        [B, N, N] f32 induced adjacency (row = out-neighbourhood),
                             or None when only ``adj_bits`` is carried
    targets    [B, T] int64  local indices of the target nodes
    size       [B] int64     valid nodes per subgraph
    hop        [B, N] int64  BFS hop from the target (-1 = unreachable)
    ppr        [B, N] f32    PPR score annotations (0 when absent)
    drnl       [B, N] int64  DRNL labels (link task; 0 otherwise)
    overflow   [] int64      over-degree members and candidate edges
                             dropped by induction: a 0-d device tensor,
                             never read on the host inside a step (a
                             pass sums it on the device); None for a
                             batch gathered from a cache
    adj_bits   [B, N, ceil(N/8)] uint8 packed adjacency (cached batches)
    """

    nodes: torch.Tensor
    node_mask: torch.Tensor
    adj: Optional[torch.Tensor]
    targets: torch.Tensor
    size: torch.Tensor
    hop: torch.Tensor
    ppr: torch.Tensor
    drnl: torch.Tensor
    overflow: Optional[torch.Tensor] = None
    adj_bits: Optional[torch.Tensor] = None


def no_overflow(device) -> torch.Tensor:
    """The overflow of an induction that drops nothing: a 0-d int64 zero."""
    return torch.zeros((), dtype=torch.int64, device=device)


def total_overflow(batches, device) -> torch.Tensor:
    """The batches' induction overflow summed on the device: a 0-d int64
    tensor (a batch gathered from a cache carries none)."""
    ovf = [b.overflow.to(device) for b in batches if b.overflow is not None]
    return torch.stack(ovf).sum() if ovf else no_overflow(device)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler configuration of one ensemble branch in one mode.

    Mirrors the per-branch sampler dicts of the reference yml.  The
    induction fields choose and size the induction strategy, as in the
    JAX package (``sampling/induction.py``): ``rows`` reads each member's
    CSR slice up to ``deg_cap`` entries, and with ``hub_slots`` > 0
    routes the members above it through a hub table (undirected graphs);
    ``cand`` enumerates up to ``cand_cap`` candidate edges a subgraph
    (directed graphs with hubs); ``hub`` is the candidate pass over the
    members up to ``deg_cap`` plus the hub table; ``search`` binary
    searches every pair, exact for any degree.
    """

    method: str                     # nodeIID | khop | ppr | ppr_st
    n_pad: int                      # subgraph node capacity
    num_targets: int = 1            # 1 = node task, 2 = link task
    depth: int = 2
    budget: int = 20
    k: int = 200
    alpha: float = 0.85
    epsilon: float = 1e-5
    threshold: float = 0.0
    add_self_edge: bool = False
    include_target_conn: bool = False
    induction: str = "search"
    cand_cap: int = 0
    deg_cap: int = 0
    hub_slots: int = 0
    aug_feats: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.method not in ("nodeIID", "khop", "ppr", "ppr_st", "full"):
            raise ValueError(f"unknown sampler {self.method!r}")


def default_n_pad(cfg_dict: dict, num_targets: int = 1, round_to: int = 8) -> int:
    """Capacity bound for a sampler config, rounded up to ``round_to``.

    ppr: at most k table entries per target, plus the target; khop: the
    targets plus ``budget**l`` nodes per target at each level l; nodeIID:
    the targets."""
    m = cfg_dict["method"]
    if m in ("ppr", "ppr_st"):
        cap = num_targets * (int(cfg_dict["k"]) + 1)
    elif m == "khop":
        cap = lvl = num_targets
        for _ in range(int(cfg_dict["depth"])):
            lvl *= int(cfg_dict["budget"])
            cap += lvl
    elif m == "nodeIID":
        cap = num_targets
    else:
        raise ValueError(f"unknown sampler {m!r}")
    return int(-(-cap // round_to) * round_to)


def sort_dedup(x: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Sort ascending along the last axis and replace duplicates with
    ``sentinel`` (which sorts last), sorted again."""
    x = torch.sort(x, dim=-1)[0]
    prev = torch.cat([torch.full_like(x[..., :1], -1), x[..., :-1]], -1)
    return torch.sort(torch.where(x == prev, torch.full_like(x, sentinel), x),
                      dim=-1)[0]


DIM_1HOT_HOP = 7      # unreachable + self + hops 1..5
DIM_1HOT_PPR = 1
DIM_1HOT_DRNL = 26    # unreachable + drnl 1..25


def one_hot(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., N] int in [0, dim) -> [..., N, dim] f32 one-hot, by a
    comparison: ``torch.nn.functional.one_hot`` reads the indices' minimum
    on the host on the CPU, and a step reads nothing there."""
    return (idx[..., None] == torch.arange(dim, device=idx.device)).float()


def hop2onehot(hop: torch.Tensor, dim: int = DIM_1HOT_HOP) -> torch.Tensor:
    """[..., N] int -> [..., N, dim] f32 one-hot.

    col 0 = unreachable (hop<0 or >=255); col h+1 for h in 0..dim-2;
    hops in [dim-1, 254] give an all-zero row, like the reference.
    """
    unreach = (hop < 0) | (hop >= 255)
    cols = torch.where(unreach, torch.zeros_like(hop), hop + 1)
    valid = unreach | (hop <= dim - 2)
    oh = one_hot(cols.clamp(0, dim - 1), dim)
    return oh * valid.unsqueeze(-1)


_PPR_BOUNDS = {}     # (dim, device) -> [2, dim] upper and lower bucket bounds


def ppr2onehot(ppr: torch.Tensor, dim: int = DIM_1HOT_PPR) -> torch.Tensor:
    """[..., N] f32 -> [..., N, dim] f32: bucket i holds scores in
    [0.25^(i+1), 0.25^i] (the last bucket down to 0); at dim 1, 1 iff
    0 <= ppr <= 1.  The bucket bounds are copied to the device once per
    (dim, device), on a step's first (eager) call: a CUDA graph's capture
    copies nothing from the host."""
    key = (dim, ppr.device)
    if key not in _PPR_BOUNDS:
        with torch.inference_mode(False):
            _PPR_BOUNDS[key] = torch.tensor(
                [[0.25 ** i for i in range(dim)],
                 [0.25 ** (i + 1) for i in range(dim - 1)] + [0.0]],
                dtype=torch.float32, device=ppr.device)
    uppers, lowers = _PPR_BOUNDS[key]
    p = ppr[..., None]
    return ((p <= uppers) & (p >= lowers)).float()


def drnl2onehot(drnl: torch.Tensor, dim: int = DIM_1HOT_DRNL) -> torch.Tensor:
    """[..., N] int -> [..., N, dim] f32 one-hot; col 0 takes the
    unreachable (255), negative and out-of-range labels."""
    d = torch.where((drnl >= 255) | (drnl > dim - 1) | (drnl < 0), 0, drnl)
    return one_hot(d, dim)


AUG2DIM = {"hops": DIM_1HOT_HOP, "pprs": DIM_1HOT_PPR, "drnls": DIM_1HOT_DRNL}


def batch_aug_onehots(batch: SubgraphBatch, aug_feats) -> dict:
    """Requested one-hot augmentations of a batch, masked to valid nodes."""
    out = {}
    m = batch.node_mask.unsqueeze(-1)
    for a in aug_feats:
        if a == "hops":
            out[a] = hop2onehot(batch.hop) * m
        elif a == "pprs":
            out[a] = ppr2onehot(batch.ppr) * m
        elif a == "drnls":
            out[a] = drnl2onehot(batch.drnl) * m
        else:
            raise ValueError(f"unknown feature augment {a!r}")
    return out
