"""The entry ``train_epochs``: ``Trainer.run_epoch(e, TRAIN)`` back to
back over every TRAIN root, whole epochs.  The first epoch (the
program's first-epoch profile, cache build and captures) is the
warm-up.  A traffic file's ``world`` > 1 runs as many ranks, each with
the Trainer's ``partition`` and its share of every batch.

What decides ``correct``, each number beside the cell's limit:

* the start, from the seed's weights: the reference follows the warm-up
  epoch's first three TRAIN steps (the step's eager warm-up, its capture
  and first replays);
  - ``loss_gap``: the relative gap of the first step's loss;
  - ``grad_gap``: the median leaf's gap between the norms of the first
    step's (clipped) gradient, over the larger of the reference leaf's
    norm and the median leaf's (the program's from Adam's first moment
    after one step over 1 - beta1);
  - ``update_gap``: the same of each parameter's change over the three
    steps, over the entries whose reference gradient is at least a
    thousandth of the median leaf's RMS gradient (the others move by
    Adam's round-off alone: :func:`moved`);
* the window: the reference follows the window's first three TRAIN
  steps, graph replays from the static buffers of the warm-up, from the
  program's state at the epoch boundary (its parameters and Adam's
  moments and step, read before the window opens), on that epoch's own
  permutation and seed;
  - ``replay_loss_gap``: the relative gap of the window's first loss;
  - ``replay_update_gap``: ``update_gap``'s measure of the change over
    the three steps.

The rest of the warm-up epoch between the two runs the same replays;
its trajectory is not followed (the program's state at its end is where
the window's check starts).  The later steps' losses and the worst
leaves are printed beside the numbers (``diag``): under Adam they swing
from seed to seed by more than the control's gap, so they decide
nothing.  The batches and masks are the Trainer's documented draws from
``numpy.random.default_rng(seed)``: one permutation for the first-epoch
profile, then a permutation and a seed each epoch.

Program members this entry uses: ``Trainer.run_epoch``, ``entity_set``,
``batch_size``, ``model``, ``optimizer`` (``torch.optim.Adam``'s
``exp_avg``, ``exp_avg_sq``, ``step``) and ``step_graphs.run`` (wrapped
by the taps; keys ``"train"`` and ``"ptrain"``); for the set-up's split
only, where they exist, ``_ensure_tables`` and ``_ensure_caches``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import optim
from benchmark.verify import TRAIN, precision, rank_seed

CHECK_STEPS = 3          # TRAIN steps the reference follows, at each end
FORWARDS_PER_ROOT = 3.0  # a TRAIN step's FLOPs, in forwards (step_mfu)
STATS_MODE = TRAIN       # the roots whose subgraphs the FLOP and byte counts take


def _params(tr) -> List:
    return list(tr.model.named_parameters())


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy in f32 (never a view of the program's tensor)."""
    return t.detach().to("cpu", torch.float32, copy=True)


class StepTap:
    """Reads the next ``CHECK_STEPS`` TRAIN steps through the Trainer's
    ``step_graphs.run``: each step's loss and each parameter after the
    last; with ``first_grad``, the gradient the optimizer got in the
    first step (Adam's first moment after one step over 1 - beta1), as
    per-leaf norms.  Then it takes itself off."""

    def __init__(self, tr, first_grad: bool):
        self.tr, self.first_grad = tr, first_grad
        self.orig = tr.step_graphs.run
        self.losses, self.grad_norms, self.params = [], {}, {}
        tr.step_graphs.run = self

    def __call__(self, key, deps, fn):
        out = self.orig(key, deps, fn)
        if key[0] not in ("train", "ptrain"):
            return out
        self.losses.append(float(out[0]))
        if len(self.losses) == 1 and self.first_grad:
            beta1 = self.tr.optimizer.param_groups[0]["betas"][0]
            state = self.tr.optimizer.state
            # no first moment: the optimizer was given nothing
            self.grad_norms = {
                k: float(torch.linalg.vector_norm(
                    state[p]["exp_avg"].double() / (1.0 - beta1)))
                if "exp_avg" in state.get(p, {}) else 0.0 for k, p in _params(self.tr)}
        if len(self.losses) == CHECK_STEPS:
            self.params = {k: _host(p) for k, p in _params(self.tr)}
            del self.tr.step_graphs.run
        return out


def snapshot(tr) -> Dict:
    """The program's training state, on the host: each parameter and
    Adam's moments and step count (zeros where Adam holds none)."""
    state = tr.optimizer.state
    out: Dict = {"params": {}, "m": {}, "v": {}, "t": 0}
    for k, p in _params(tr):
        s = state.get(p, {})
        out["params"][k] = _host(p)
        zero = torch.zeros_like(out["params"][k])
        out["m"][k] = _host(s["exp_avg"]) if "exp_avg" in s else zero
        out["v"][k] = _host(s["exp_avg_sq"]) if "exp_avg_sq" in s else zero
        if "step" in s:
            out["t"] = int(s["step"])
    return out


class Driver:
    """The program's side of one run: set-up, warm-up, window units."""

    def __init__(self, tr, cell: Dict, weights: Dict[str, torch.Tensor], split):
        self.tr = tr
        self.n_roots = int(len(tr.entity_set[TRAIN]))
        # the program's own first steps of run_epoch, timed apart
        for name, part in (("_ensure_tables", "ppr"), ("_ensure_caches", "cache")):
            if hasattr(tr, name):
                getattr(tr, name)(TRAIN)
                split(part)
        start = StepTap(tr, first_grad=True)
        tr.run_epoch(0, TRAIN)
        self.start = start
        self.boundary = snapshot(tr)
        self.window = StepTap(tr, first_grad=False)

    def unit(self, e: int):
        """One window unit: a whole epoch; (roots, steps)."""
        self.tr.run_epoch(e, TRAIN)
        return self.n_roots, -(-self.n_roots // self.tr.batch_size)

    def collect(self) -> Dict:
        """What the reference judges, once the window has closed."""
        return {"start": {"losses": self.start.losses,
                          "grad_norms": self.start.grad_norms,
                          "params": self.start.params},
                "boundary": self.boundary,
                "window": {"losses": self.window.losses, "params": self.window.params}}


def end_to_end(out: Dict) -> Dict[str, float]:
    """The window's TRAIN roots (subgraphs) a second, over all ranks."""
    return {"train_subg_per_s": out["roots"] / out["window_s"]}


# ---------------------------------------------------------------- reference
def _draws(ref, n: int):
    """[(permutation, seed)] of the Trainer's first two TRAIN epochs."""
    rng = np.random.default_rng(ref.seed)
    rng.permutation(n)                       # the first-epoch profile's draw
    out = []
    for _ in range(2):
        perm = rng.permutation(n)
        out.append((perm, int(rng.integers(1 << 31))))
    return out


def follow(ref, params: Dict[str, torch.Tensor], adam: optim.Adam, perm: np.ndarray,
           epoch_seed: int, tf32: bool = False, half: bool = False) -> Dict:
    """The reference's first ``CHECK_STEPS`` TRAIN steps of an epoch of
    ``perm`` and ``epoch_seed`` from ``params`` and ``adam``: the
    losses, the first (clipped) gradient, the parameters after.
    ``half``: the half-batch fault (each rank's first half of the rows
    left out, the mean taken over the rest)."""
    cfg, traffic = ref.cfg, ref.cell["traffic"]
    hyper = cfg["train_config"]["hyperparameter"]
    b = int(hyper["batch_size"])
    world = int(traffic.get("world", 1))
    per = b // world
    roots_all = ref.data["node_set"][TRAIN][perm[:CHECK_STEPS * b]]
    sub_all = ref.subgraphs(TRAIN, roots_all)
    gens = [(torch.Generator(device=ref.device).manual_seed(rank_seed(epoch_seed, r)),
             torch.Generator().manual_seed(rank_seed(epoch_seed, r) ^ 0x5BD1E995))
            for r in range(world)]
    params = {k: v.to(ref.device).clone() for k, v in params.items()}
    losses, grad1 = [], None
    p_edge = float(hyper.get("dropedge", 0.0))
    with precision(tf32):
        for s in range(CHECK_STEPS):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            num, den = 0.0, 0.0
            for r, (g_drop, g_edge) in enumerate(gens):
                lo = s * b + r * per
                sl = slice(lo, lo + per)
                sub = {k: v[sl] for k, v in sub_all.items()}
                edge_seed = (int(torch.randint(0, 2**31 - 1, (), generator=g_edge))
                             if p_edge > 0 else 0)
                logits = ref.model.forward(leaves, sub, ref.feat, cfg, True, g_drop,
                                           edge_seed)
                lab = ref.label[torch.as_tensor(roots_all[sl], device=ref.device)]
                w = torch.ones(per, device=ref.device)
                if half:
                    w[: per // 2] = 0.0
                nr, dr = optim.weighted_ce(logits, lab, w)
                num, den = num + nr, den + dr
            loss = num / torch.clamp(den, min=1.0)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            grads = optim.clip(grads)
            if s == 0:
                grad1 = {k: g.detach().float().cpu() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            params = adam.step(params, grads)
    return {"losses": losses, "grad1": grad1, "grad_norms": optim.leaf_norms(grad1),
            "params": {k: v.float().cpu() for k, v in params.items()}}


def reference_runs(ref, boundary: Dict, tf32: bool = False, half: bool = False) -> Dict:
    """The reference's steps at both ends: from the seed's weights over
    the warm-up epoch's batches, and from the program's state at the
    boundary over the window's first epoch."""
    lr = float(ref.cfg["train_config"]["hyperparameter"]["lr"])
    (perm0, seed0), (perm1, seed1) = _draws(ref, ref.data["node_set"][TRAIN].size)
    start = follow(ref, ref.w0, optim.Adam(ref.w0, lr), perm0, seed0, tf32, half)
    dev = {k: {n: t.to(ref.device) for n, t in boundary[k].items()} for k in ("m", "v")}
    adam = optim.Adam(boundary["params"], lr, m=dev["m"], v=dev["v"], t=boundary["t"])
    window = follow(ref, boundary["params"], adam, perm1, seed1, tf32, half)
    return {"start": start, "window": window}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def moved(grad1: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's entries whose reference gradient is not nought to
    rounding: at least a thousandth of the median leaf's RMS gradient.
    The others (a GAT attention's self half under the softmax) move by
    Adam's round-off alone."""
    rms = {k: float(torch.linalg.vector_norm(g.double())) / max(g.numel(), 1) ** 0.5
           for k, g in grad1.items()}
    floor = 1e-3 * statistics.median(rms.values())
    return {k: g.abs() >= floor for k, g in grad1.items()}


def _update_gaps(prog_params, want: Dict, base: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keep = moved(want["grad1"])
    names = [k for k, m in keep.items() if bool(m.any())]

    def norms(params):
        return {k: float(torch.linalg.vector_norm(
            (params[k] - base[k].float().cpu())[keep[k]].double())) for k in names}
    return _leaf_gaps(norms(prog_params), norms(want["params"]))


def _loss_gaps(prog: List[float], want: List[float]) -> List[float]:
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, want)]


def compare(prog: Dict, want: Dict, w0: Dict[str, torch.Tensor], boundary: Dict,
            diag: Optional[Dict] = None) -> Dict[str, float]:
    """The compared numbers of the program's readings ``prog`` against
    the reference's ``want``; ``diag`` gets the unsteady ones."""
    s, ws = prog["start"], want["start"]
    grad = _leaf_gaps(s["grad_norms"], ws["grad_norms"])
    update = _update_gaps(s["params"], ws, w0)
    w, ww = prog["window"], want["window"]
    replay = _update_gaps(w["params"], ww, boundary["params"])
    losses, r_losses = _loss_gaps(s["losses"], ws["losses"]), _loss_gaps(w["losses"],
                                                                        ww["losses"])
    if diag is not None:
        diag.update({"loss_gap_steps": losses, "replay_loss_gap_steps": r_losses,
                     "grad_gap_worst": [max(grad, key=grad.get), max(grad.values())],
                     "update_gap_worst": [max(update, key=update.get), max(update.values())],
                     "replay_update_gap_worst": [max(replay, key=replay.get),
                                                 max(replay.values())]})
    return {"loss_gap": losses[0], "grad_gap": statistics.median(grad.values()),
            "update_gap": statistics.median(update.values()),
            "replay_loss_gap": r_losses[0],
            "replay_update_gap": statistics.median(replay.values())}


def judge(ref, out: Dict) -> tuple:
    """(compared numbers, diagnostics, the reference's runs) of the
    program's run ``out``."""
    prog = out["program"]
    diag = {"label_steps": [out["preproc"].get("label_smoothen_steps"), ref.label_steps]}
    want = reference_runs(ref, prog["boundary"])
    return compare(prog, want, ref.w0, prog["boundary"], diag), diag, want


def control(ref, out: Dict, fault: str, want: Optional[Dict] = None) -> Dict[str, float]:
    """The numbers of the reference in the program's place: with its
    products in TF32 (``fault`` "tf32", the control), or with half of
    each batch left out ("half_batch"), against the f32 reference
    (``want``, else worked out), from the same boundary state as the
    program's run ``out``."""
    boundary = out["program"]["boundary"]
    low = reference_runs(ref, boundary, tf32=fault == "tf32", half=fault == "half_batch")
    want = want if want is not None else reference_runs(ref, boundary)
    return compare(low, want, ref.w0, boundary)
