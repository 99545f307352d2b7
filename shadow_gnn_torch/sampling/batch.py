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
    overflow   int           over-degree members dropped by induction
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
    overflow: int = 0
    adj_bits: Optional[torch.Tensor] = None


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
AUG2DIM = {"hops": DIM_1HOT_HOP}


def hop2onehot(hop: torch.Tensor, dim: int = DIM_1HOT_HOP) -> torch.Tensor:
    """[..., N] int -> [..., N, dim] f32 one-hot.

    col 0 = unreachable (hop<0 or >=255); col h+1 for h in 0..dim-2;
    hops in [dim-1, 254] give an all-zero row, like the reference.
    """
    unreach = (hop < 0) | (hop >= 255)
    cols = torch.where(unreach, torch.zeros_like(hop), hop + 1)
    valid = unreach | (hop <= dim - 2)
    oh = torch.nn.functional.one_hot(cols.clamp(0, dim - 1), dim).float()
    return oh * valid.unsqueeze(-1)


def batch_aug_onehots(batch: SubgraphBatch, aug_feats) -> dict:
    """Requested one-hot augmentations of a batch, masked to valid nodes."""
    out = {}
    m = batch.node_mask.unsqueeze(-1)
    for a in aug_feats:
        if a != "hops":
            raise NotImplementedError(
                f"feature augment {a!r} is not ported yet (only 'hops')")
        out["hops"] = hop2onehot(batch.hop) * m
    return out
