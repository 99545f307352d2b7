"""PyTorch port, the ring SpMM's compiled programs and ``n_shards: 1``.

The ring SpMM (``shadow_gnn_torch/parallel/edgepart.py``) runs as CUDA
graphs on a card: each product of ``make_ring_spmm`` under the key
``("ring", F)``, the whole C&S loop of ``make_outcome_correlation`` (and
the single-card ``postproc/cns.py:Propagation``) under ``("cs", n_prop,
F, alpha, use_norm, clamp)``.  Here, on the CPU:

* outside a process group the collectives answer locally, so
  ``n_shards=1`` gives JAX's ``n_shards=1`` answer (before, it raised):
  the ring product at rtol 1e-5 / atol 1e-5, the smoothening and the C&S
  propagation at rtol 2e-4 / atol 1e-5 (``tests/test_torch_edgepart.py``'s
  tolerances), and the CLI's C&S (a JSON config) JAX's accuracies;
* the same static-buffer functions with stub graphs that do what a CUDA
  graph does (a capture runs once, a replay runs again and writes into
  the captured outputs; ``tests/test_torch_partition_graphs.py:_Replay``)
  against their eager twins (``cuda_graphs=False``), bit for bit, every
  call of a key after its first replaying: the single-card propagation
  in this process, the ring product and C&S on a gloo world of 2 (one
  spawn for the file; a gloo rank's own graphs stay off and say so),
  with the collectives' calls and bytes credited per replay, and the
  graphs released by ``release_all``; the world-2 results against JAX's
  on 2 devices at the tolerances above;
* ``--distributed`` under torchrun's variables at a world of 1 joins the
  launcher's address.
"""
import json
import os

import numpy as np
import pytest
import torch

from shadow_gnn_torch.parallel import collectives as cc
from shadow_gnn_torch.parallel import edgepart as ep
from shadow_gnn_torch.parallel import launch
from shadow_gnn_torch.parallel import multihost as mh
from shadow_gnn_torch.train import graphs
from test_torch_partition_graphs import _Replay

WORLD = 2
RING_TOL = dict(rtol=1e-5, atol=1e-5)
USER_TOL = dict(rtol=2e-4, atol=1e-5)
SMOOTH_ARGS = {"alpha": 0.9, "norm_adj": "sym", "itr_max": 5, "thres": 1e-9,
               "norm_feat": "none"}


def undirected_csr(n, avg_deg, seed):
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    u = np.concatenate([src[keep], dst[keep]])
    v = np.concatenate([dst[keep], src[keep]])
    pairs = np.unique(np.stack([u, v], 1), axis=0)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(pairs[:, 0], minlength=n))])
    return indptr.astype(np.int64), pairs[:, 1].astype(np.int32)


def inputs():
    """Every case's inputs from fixed seeds (numpy only)."""
    rs = np.random.default_rng(7)
    spmm = (rs.integers(0, 203, 1200), rs.integers(0, 203, 1200),
            rs.normal(size=1200).astype(np.float32))
    xs = [rs.normal(size=(203, 5)).astype(np.float32) for _ in range(3)]
    rc = np.random.default_rng(9)
    y0s = [rc.uniform(size=(120, 6)).astype(np.float32) for _ in range(3)]
    return dict(spmm=spmm, xs=xs, g_cs=undirected_csr(120, 5, 9), y0s=y0s,
                g_sm=undirected_csr(150, 6, 8),
                sig=np.random.default_rng(8).normal(size=(150, 4)).astype(np.float32))


def stub(sg):
    """``sg``'s graphs on, with stubs that behave as CUDA graphs do."""
    sg.enabled = True
    sg.generator, sg.sampler = torch.Generator(), torch.Generator()
    sg._warm = lambda fn: fn()

    def record(fn):
        outputs = fn()
        return _Replay(fn, outputs), outputs
    sg._record = record


def _counts(fn):
    """(fn()'s result, the collectives' calls and bytes it added)."""
    before = (cc.stats["calls"], cc.stats["bytes"])
    out = fn()
    return out, (cc.stats["calls"] - before[0], cc.stats["bytes"] - before[1])


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------

def rank_ring(out_dir):
    """One gloo rank: the ring product and the C&S loop, graphed (stubs)
    and eager, three calls each (warm-up, capture + replay, replay)."""
    inp, r = inputs(), mh.rank()
    out = {}
    src, dst, val = inp["spmm"]
    graphed = ep.make_ring_spmm(src, dst, val, 203, WORLD, "cpu")
    out["gloo_plan"] = np.asarray(graphed.graphs.summary())
    stub(graphed.graphs)
    eager = ep.make_ring_spmm(src, dst, val, 203, WORLD, "cpu", cuda_graphs=False)
    counts = []
    for i, x in enumerate(inp["xs"]):
        out[f"ring_g{i}"], cg = _counts(lambda: graphed(x).numpy())
        out[f"ring_e{i}"], ce = _counts(lambda: eager(x).numpy())
        counts.append(cg + ce)
    out["ring_counts"] = np.asarray(counts)
    out["ring_replays"] = np.asarray(graphed.graphs.replays[("ring", 5)])
    cs_g = ep.make_outcome_correlation(*inp["g_cs"], WORLD, "cpu")
    stub(cs_g.graphs)
    cs_e = ep.make_outcome_correlation(*inp["g_cs"], WORLD, "cpu", cuda_graphs=False)
    for use_norm in (False, True):
        for i, y0 in enumerate(inp["y0s"]):
            out[f"cs{int(use_norm)}_g{i}"] = cs_g(y0, 10, 0.8, use_norm).clone().numpy()
            out[f"cs{int(use_norm)}_e{i}"] = cs_e(y0, 10, 0.8, use_norm).numpy()
    out["cs_replays"] = np.asarray(sorted(cs_g.graphs.replays.values()))
    live = [cs_g.graphs in graphs._LIVE, graphed.graphs in graphs._LIVE]
    graphs.release_all()
    out["released"] = np.asarray(live + [not cs_g.graphs.graphs,
                                         not graphed.graphs.graphs])
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    launch.spawn(rank_ring, WORLD, "cpu", (str(tmp),), threads=1)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# n_shards 1 outside a group
# ---------------------------------------------------------------------------

def test_collectives_answer_locally_outside_a_group():
    assert not torch.distributed.is_initialized()
    t = torch.arange(6.0).reshape(3, 2)
    before = dict(cc.stats)
    assert torch.equal(cc.all_gather(t), t[None])
    assert torch.equal(cc.all_gather_rows(t), t)
    assert torch.equal(cc.reduce_scatter_sum(t[None]), t)
    assert torch.equal(cc.reduce_scatter_sum(t[None] > 2, async_op=True).wait(), t > 2)
    s = cc.all_reduce_sum(t)
    assert torch.equal(s, t) and s.data_ptr() != t.data_ptr()
    assert torch.equal(cc.ring_shift(t).wait(), t)
    assert cc.stats == before                  # nothing travelled


@pytest.mark.parametrize("case", ["ring", "cs_plain", "cs_norm", "smooth_sym",
                                  "smooth_ppr"])
def test_n_shards_1_outside_a_group_matches_jax(case):
    """``n_shards=1`` in a process of no group (it raised ValueError
    before): the ring product, the C&S propagation through
    ``general_outcome_correlation`` and the smoothening, against JAX's
    ``n_shards=1`` on one device."""
    from shadow_gnn_tpu.parallel.edgepart import make_ring_spmm as j_ring
    from shadow_gnn_tpu.postproc.cns import general_outcome_correlation as j_cs
    from shadow_gnn_tpu.train.preproc import smooth_signal_full as j_smooth
    from shadow_gnn_torch.postproc.cns import general_outcome_correlation
    from shadow_gnn_torch.train.preproc import smooth_signal_full
    inp = inputs()
    if case == "ring":
        src, dst, val = inp["spmm"]
        got = ep.make_ring_spmm(src, dst, val, 203, 1, "cpu")(inp["xs"][0]).numpy()
        want = np.asarray(j_ring(src, dst, val, 203, 1)(inp["xs"][0]))
        tol = RING_TOL
    elif case.startswith("cs"):
        norm = case == "cs_norm"
        got = general_outcome_correlation(*inp["g_cs"], inp["y0s"][0], n_prop=10,
                                          use_norm=norm, n_shards=1, device="cpu")
        want = j_cs(*inp["g_cs"], inp["y0s"][0], n_prop=10, use_norm=norm, n_shards=1)
        tol = USER_TOL
    else:
        tn = case.split("_")[1]
        got = smooth_signal_full(*inp["g_sm"], inp["sig"], tn, 2, "concat",
                                 SMOOTH_ARGS, "cpu", n_shards=1)[0]
        want = j_smooth(*inp["g_sm"], inp["sig"], tn, 2, "concat", SMOOTH_ARGS,
                        n_shards=1)
        tol = USER_TOL
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_cli_cs_at_n_shards_1(tmp_path, capsys, monkeypatch):
    """``--postproc_configs`` with ``method: cs`` and ``n_shards: 1`` (a
    JSON config, which needs no PyYAML) on a run dir holding a
    prediction matrix: JAX's ``correct_smooth`` accuracies, in this
    process, no group made."""
    from shadow_gnn_tpu.postproc.cns import correct_smooth as j_cs
    from shadow_gnn_torch.data import load_data, make_synthetic_dataset, \
        save_shadow_format
    from shadow_gnn_torch.main import main
    from shadow_gnn_torch.postproc import cns
    g = make_synthetic_dataset(num_nodes=300, avg_deg=6, num_feat=4, num_classes=4,
                               seed=3)
    data = str(tmp_path / "data")
    save_shadow_format(data, "toy", indptr=g.indptr_full, indices=g.indices_full,
                       feat=g.feat_full, label=g.label_full, node_set=g.node_set)
    run = tmp_path / "run"
    run.mkdir()
    pred = np.random.default_rng(0).random((300, 4)).astype(np.float32)
    np.save(run / "pred_mat_gen.npy", pred)
    with open(tmp_path / "cs.json", "w") as f:
        json.dump({"method": "cs", "dir_pred_mat": [str(run)],
                   "hyperparameter": {"norm_sym": True, "alpha": 0.8,
                                      "n_shards": 1}}, f)
    seen, orig = [], cns.correct_smooth
    monkeypatch.setattr(cns, "correct_smooth",
                        lambda *a: seen.append(orig(*a)) or seen[-1])
    assert main(["--postproc_configs", str(tmp_path / "cs.json"), "--dataset", "toy",
                 "--data_dir", data, "--log_dir", str(tmp_path / "log"),
                 "--device", "cpu"]) == 0
    assert "C&S acc" in capsys.readouterr().out and not mh.world_size() > 1
    raw = load_data(data, "toy", {"to_undirected": True, "transductive": True})
    want = j_cs(raw.indptr_full, raw.indices_full, raw.label_full, raw.node_set,
                [pred], True, 0.8)
    assert seen == [want]


# ---------------------------------------------------------------------------
# the static-buffer functions against their eager twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_norm", [False, True])
def test_single_card_propagation_graph_equals_eager(use_norm):
    """``Propagation``: three matrices through one key (warm-up, capture
    + replay, replay), each equal to ``propagate`` on fresh tensors bit
    for bit; the graph is released by ``release_all``."""
    from shadow_gnn_torch.postproc import cns
    inp = inputs()
    op, deg = cns.mean_operator(*inp["g_cs"], "cpu")
    prop = cns.Propagation(op, deg)
    assert "every step runs eagerly" in prop.graphs.summary()
    stub(prop.graphs)
    for y0 in inp["y0s"]:
        y0 = torch.as_tensor(y0)
        got = prop(y0, 10, 0.8, use_norm).clone()
        assert torch.equal(got, cns.propagate(op, deg, y0, 10, 0.8, use_norm))
    key = ("cs", 10, 6, 0.8, use_norm, (0.0, 1.0))
    assert prop.graphs.replays == {key: 2} and prop.graphs.warmups == {key: 1}
    assert prop.graphs in graphs._LIVE
    graphs.release_all()
    assert not prop.graphs.graphs


def test_ring_product_graphed_equals_eager(ranks):
    """Each rank's graphed products equal the eager twin's bit for bit,
    the second and third calls replaying; the collectives' calls and
    bytes of a replayed product equal the eager one's (credited per
    replay)."""
    for o in ranks:
        for i in range(3):
            np.testing.assert_array_equal(o[f"ring_g{i}"], o[f"ring_e{i}"])
        assert int(o["ring_replays"]) == 2
        c = o["ring_counts"]
        assert (c[:, :2] == c[:, 2:]).all() and (c[:, 0] > 0).all()
    np.testing.assert_array_equal(ranks[0]["ring_g2"], ranks[1]["ring_g2"])


@pytest.mark.parametrize("use_norm", [0, 1])
def test_ring_cs_graphed_equals_eager(ranks, use_norm):
    for o in ranks:
        for i in range(3):
            np.testing.assert_array_equal(o[f"cs{use_norm}_g{i}"],
                                          o[f"cs{use_norm}_e{i}"])
        assert o["cs_replays"].tolist() == [2, 2]       # one key a use_norm


def test_ring_world_2_matches_jax(ranks):
    """The world-2 ring product and C&S against JAX's on 2 devices."""
    from shadow_gnn_tpu.parallel.edgepart import (distributed_outcome_correlation,
                                                  make_ring_spmm)
    inp = inputs()
    src, dst, val = inp["spmm"]
    fn = make_ring_spmm(src, dst, val, 203, WORLD)
    for i, x in enumerate(inp["xs"]):
        np.testing.assert_allclose(ranks[0][f"ring_g{i}"], np.asarray(fn(x)),
                                   **RING_TOL)
    for use_norm in (False, True):
        want = distributed_outcome_correlation(*inp["g_cs"], inp["y0s"][1], n_prop=10,
                                               use_norm=use_norm, n_devices=WORLD)
        np.testing.assert_allclose(ranks[1][f"cs{int(use_norm)}_g1"], want,
                                   **USER_TOL)


def test_gloo_ring_runs_eagerly_and_releases(ranks):
    """A gloo rank's ring graphs are off and say so; the stubbed graphs
    were registered for ``release_all``, which destroyed them."""
    for o in ranks:
        assert "every step runs eagerly" in str(o["gloo_plan"])
        assert o["released"].all()


def test_distributed_joins_the_launcher_at_world_1(monkeypatch, capsys):
    """``--distributed`` under torchrun's variables at a world of 1 joins
    the launcher's address (before, a group of one on a free port)."""
    import types

    from shadow_gnn_torch.main import _join_group
    port = mh.free_port()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                     LOCAL_RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    args = types.SimpleNamespace(device="cpu", partition_devices=0)
    try:
        assert _join_group(args) == 0
        assert (mh.world_size(), mh.backend(), args.device) == (1, "gloo", "cpu")
        assert f"joined at 127.0.0.1:{port}" in capsys.readouterr().out
    finally:
        mh.shutdown()
