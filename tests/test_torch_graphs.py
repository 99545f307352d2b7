"""PyTorch port, the compiled step (``shadow_gnn_torch/train/graphs.py``).

The dropedge seed as a one-element int64 tensor (a CUDA graph's static
seed buffer) gives the int seed's masks bit for bit: ``dropedge_mask``,
every dense normalisation, ``prepare_adj``, ``branch_seed``, the plain
packed product in both directions, and the backward of ``packed_spmm``
after its seed buffer was overwritten.  The cached steps as functions
of static buffers, called uncaptured on the CPU, give the eager step's
per-batch losses and predictions and its final parameters and Adam
state bit for bit over 2 TRAIN epochs and a VALID pass (a toy flagship
SAGE with the packed product and a toy GAT, both with dropout and
dropedge), and the JAX Trainer's TRAIN losses at dropout 0 and dropedge
0 (rtol 1e-4, as ``tests/test_torch_train.py`` holds them).  With stub
graphs in place of CUDA's: the first call of a key is its eager
warm-up, the second its capture and replay, a replay credits the
launch counters with the capture's counts, replaced dependencies make
a new warm-up, and a capture that fails raises out of a Trainer's epoch
with no eager fallback."""
import jax
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TRAIN as J_TRAIN
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger as JLogger
from shadow_gnn_tpu.train.metrics import Metrics as JMetrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch import TRAIN, VALID
from shadow_gnn_torch.convert import params_from_flax
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.nn.model import branch_seed
from shadow_gnn_torch.ops import normalize
from shadow_gnn_torch.ops.packed import packed_spmm, packed_spmm_plain
from shadow_gnn_torch.sampling.cache import pack_bits
from shadow_gnn_torch.train import graphs
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import EpochRNG, Trainer

torch.set_num_threads(2)
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)
SAGE_CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 3, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-4, "dropout": 0.2,
                       "dropedge": 0.1, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}
# the products GAT-5 leaderboard model's kind at test size
GAT_CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "gat", "heads": 2, "loss": "softmax",
                     "num_layers": 2, "act": "prelu", "feature_augment": "none",
                     "use_label": "no_valid", "label_smoothen": "ppr--concat-0.8",
                     "residue": "max", "pooling": "max"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.2, "dropedge": 0.1,
                       "batch_size": 32},
    "sampler": [{"method": "full", "phase": "preprocess"},
                {"method": "ppr", "phase": "train", "k": [16], "epsilon": [1e-5]}],
}
SEEDS = (0, 7, 123456789, 2**31 - 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_seed_masks_equal_int_seed(seed):
    adj = (torch.rand(3, 21, 21, generator=torch.Generator().manual_seed(seed % 97))
           < 0.3).float()
    for s in (torch.tensor(seed), torch.tensor([seed]),
              torch.tensor(seed, dtype=torch.int32)):
        assert torch.equal(normalize.dropedge_mask(s, 3, 21, 0.3),
                           normalize.dropedge_mask(seed, 3, 21, 0.3))
        for fn in (normalize.adj_norm_sym, normalize.adj_norm_rw,
                   normalize.adj_gin_rescale, normalize.adj_drop):
            assert torch.equal(fn(adj, s, 0.3), fn(adj, seed, 0.3)), fn.__name__
        for aggr in ("gcn", "sage", "gin", "gat", "gatscat", "mlp"):
            got = normalize.prepare_adj(aggr, adj, s, 0.3)
            want = normalize.prepare_adj(aggr, adj, seed, 0.3)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), aggr
    for i in range(4):
        t = branch_seed(torch.tensor(seed), i)
        assert t.dtype == torch.int64 and int(t) == branch_seed(seed, i)


@pytest.mark.parametrize("norm", ["none", "rw", "sym", "gin"])
def test_packed_product_tensor_seed(norm):
    """The plain packed product and its transpose under a tensor seed
    equal the int form; ``packed_spmm``'s backward hashes the seed its
    forward read, though the buffer was overwritten in between."""
    gen = torch.Generator().manual_seed(1)
    bits = pack_bits((torch.rand(4, 20, 20, generator=gen) < 0.25).float())
    x = torch.randn(4, 20, 8, generator=gen)
    for transpose in (False, True):
        got = packed_spmm_plain(bits, x, norm, 0.3, torch.tensor(77), transpose)
        assert torch.equal(got, packed_spmm_plain(bits, x, norm, 0.3, 77, transpose))
    buf = torch.zeros((), dtype=torch.int64)
    x1 = x.clone().requires_grad_()
    buf.fill_(77)
    y = packed_spmm(bits, x1, norm, 0.3, buf)
    buf.fill_(5)                          # the next step's seed
    (y * torch.arange(8.0)).sum().backward()
    x2 = x.clone().requires_grad_()
    want = packed_spmm(bits, x2, norm, 0.3, 77)
    (want * torch.arange(8.0)).sum().backward()
    assert torch.equal(y, want) and torch.equal(x1.grad, x2.grad)


def _trainer(cfg, **kw):
    tr = Trainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0, device="cpu",
                 packed_adj=True, **kw)
    tr.profiler.enabled = False
    return tr


def _eager_pass(tr, mode, train, nb, roots, rows, labels, w, rng):
    """The eager pass the static-buffer step replaces: each batch from
    ``_sample_branch_batches``, then ``_train_step`` or ``_eval_step``."""
    lab, w_t = torch.as_tensor(labels.astype(np.int64)), torch.as_tensor(w)
    tr.model.train(train)
    losses, preds = [], []
    for sl, batches, feats in tr._batches(mode, nb, roots, rows, rng.sample):
        if train:
            loss, pred = tr._train_step(batches, feats, lab[sl], w_t[sl], rng)
        else:
            loss, pred = tr._eval_step(batches, feats, lab[sl], w_t[sl],
                                       mode_train=mode == TRAIN)
        losses.append(loss)
        preds.append(pred)
    tr.model.eval()
    return torch.stack(losses).numpy(), torch.cat(preds).numpy()


@pytest.mark.parametrize("cfg", [SAGE_CFG, GAT_CFG], ids=["sage", "gat"])
def test_static_step_equals_eager_step(cfg, monkeypatch):
    """2 TRAIN epochs and a VALID pass: the static-buffer steps (what a
    CUDA graph captures), called on the CPU, against the eager steps of
    the same trainer's twin, bit for bit."""
    static, eager = _trainer(cfg), _trainer(cfg)
    calls = []
    for name in ("_static_train", "_static_eval"):
        fn = getattr(static, name)
        monkeypatch.setattr(static, name, lambda *a, fn=fn, name=name:
                            calls.append(name) or fn(*a))
    for mode, train in ((TRAIN, True), (TRAIN, True), (VALID, False)):
        out = []
        for tr in (static, eager):
            tr._ensure_tables(mode)
            tr._ensure_caches(mode)
            nb, roots, rows, labels, w = tr._epoch_arrays(mode)
            rng = EpochRNG.from_seed(int(tr.rng_np.integers(1 << 31)), tr.device)
            if tr is static:
                assert tr._cached(mode)
                losses, preds, _ = tr._run_batches(mode, train, nb, roots, rows,
                                                   labels, w, rng)
            else:
                losses, preds = _eager_pass(tr, mode, train, nb, roots, rows,
                                            labels, w, rng)
            out.append((nb, losses, preds))
        (nb, l_s, p_s), (_, l_e, p_e) = out
        np.testing.assert_array_equal(l_s, l_e)
        np.testing.assert_array_equal(p_s, p_e)
        assert calls.count("_static_train" if train else "_static_eval") == nb
        calls.clear()
    sd_s, sd_e = static.model.state_dict(), eager.model.state_dict()
    assert all(torch.equal(sd_s[k], sd_e[k]) for k in sd_e)
    o_s, o_e = (t.optimizer.state_dict()["state"] for t in (static, eager))
    assert o_s.keys() == o_e.keys() and all(
        torch.equal(o_s[k][n], o_e[k][n]) for k in o_e for n in o_e[k])
    assert not static.step_graphs.enabled and not static.step_graphs.replays


def test_static_step_losses_match_jax(monkeypatch):
    """The flagship's static-buffer TRAIN step against the JAX Trainer's
    epoch, on the same weights, at dropout 0 and dropedge 0."""
    cfg = dict(SAGE_CFG, hyperparameter=dict(SAGE_CFG["hyperparameter"], dropout=0.0,
                                             dropedge=0.0))
    m = JMetrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   JLogger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True)
    jtr.profiler.enabled = False
    ttr = _trainer(cfg)
    ttr.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    jtr._ensure_tables(J_TRAIN)
    jtr._ensure_caches(J_TRAIN)
    nb, roots, rows, lab, w, _, _ = jtr._epoch_arrays(J_TRAIN)
    rng = jax.random.PRNGKey(jtr.rng_np.integers(1 << 31))
    _, _, j_losses, _, _ = jtr._make_epoch_fn(J_TRAIN, nb, True)(
        jtr.params, jtr.opt_state, rng, roots, rows, lab, w, jtr._mode_arrays(J_TRAIN))
    ttr._ensure_tables(TRAIN)
    ttr._ensure_caches(TRAIN)
    steps = []
    fn = ttr._static_train
    monkeypatch.setattr(ttr, "_static_train", lambda *a: steps.append(1) or fn(*a))
    t_nb, t_roots, t_rows, t_lab, t_w = ttr._epoch_arrays(TRAIN)
    t_losses, _, _ = ttr._run_batches(
        TRAIN, True, t_nb, t_roots, t_rows, t_lab, t_w,
        EpochRNG.from_seed(int(ttr.rng_np.integers(1 << 31)), ttr.device))
    assert nb == t_nb == len(steps)
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4)


class _StubGraph:
    """Stands in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_graphs(sg, fail=False):
    """``sg`` enabled with stub graphs: the warm-up runs the step where it
    stands, a capture runs it once (as a capture runs the Python) and
    returns a stub graph, or raises with ``fail``."""
    sg.enabled = True
    sg.generator = torch.Generator()
    recorded = []

    def record(fn):
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        out = fn()
        recorded.append(_StubGraph())
        return recorded[-1], out

    sg._warm = lambda fn: fn()
    sg._record = record
    return recorded


def test_replays_credit_the_captured_launches():
    sg = graphs.StepGraphs(torch.device("cpu"), True)
    assert not sg.enabled and sg.generator is None      # never on the CPU
    recorded = _stub_graphs(sg)
    runs = []

    def step():
        runs.append(1)
        packed_spmm.launches += 3
        packed_spmm.launches_by_norm["rw"] += 3
        return (torch.zeros(()),)

    deps = (object(),)
    l0, n0 = packed_spmm.launches, packed_spmm.launches_by_norm["rw"]
    for i in range(1, 5):
        sg.run(("train", 0, 8), deps, step)
        assert packed_spmm.launches - l0 == 3 * i
        assert packed_spmm.launches_by_norm["rw"] - n0 == 3 * i
    # a warm-up, then one capture: the Python ran twice, the graph 3 times
    assert len(runs) == 2 and len(recorded) == 1 and recorded[0].replays == 3
    assert sg.warmups[("train", 0, 8)] == 1 and sg.replays[("train", 0, 8)] == 3
    # a replaced dependency: a new warm-up, then a new capture
    sg.run(("train", 0, 8), (object(),), step)
    assert len(runs) == 3 and len(recorded) == 1
    with sg.paused():
        sg.run(("train", 0, 8), deps, step)
    assert len(runs) == 4 and packed_spmm.launches - l0 == 18


def test_capture_failure_raises_from_the_epoch():
    """A graphed Trainer whose capture fails: the epoch raises at its
    second step (the capture), with no step run eagerly in its place."""
    tr = _trainer(SAGE_CFG)
    _stub_graphs(tr.step_graphs, fail=True)
    steps = []
    fn = tr._static_train
    tr._static_train = lambda *a: steps.append(1) or fn(*a)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        tr.run_epoch(0, TRAIN)
    assert len(steps) == 1 and sum(tr.step_graphs.warmups.values()) == 1
