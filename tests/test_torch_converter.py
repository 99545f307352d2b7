"""PyTorch port, dataset ingestion (``data/converter.py``, the loader's
auto-conversion) against the JAX package.

Archives of every layout are made with numpy in ``tmp_path``: the
shaDow layout, the GraphSAINT layout, OGB node CSVs (gzip, with empty
fields) and its ``data.npz`` variant, and OGB link splits as ``.pt``
pickles; each is ingested by both packages, and every file the port
writes must equal JAX's byte for byte.  The CSV reader is held against
JAX's on the edge cases (empty fields and lines, chunk boundaries), and
the loader's dispatch of a missing dataset directory against JAX's."""
import gzip
import json
import os
import tarfile
import zipfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from shadow_gnn_tpu.data import converter as jconv
from shadow_gnn_tpu.data.format import save_shadow_format as j_save
from shadow_gnn_tpu.data.loader import load_data as j_load
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.data import converter as tconv
from shadow_gnn_torch.data import load_data as t_load
from shadow_gnn_torch.data import make_synthetic_dataset


def _tar(src_dir, out_path):
    with tarfile.open(out_path, "w:gz") as t:
        t.add(src_dir, arcname=os.path.basename(src_dir))
    return str(out_path)


def _zip(src_dir, out_path):
    with zipfile.ZipFile(out_path, "w") as z:
        for d, _, files in os.walk(src_dir):
            for f in files:
                p = os.path.join(d, f)
                z.write(p, os.path.relpath(p, os.path.dirname(src_dir)))
    return str(out_path)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _ingest_both(tmp_path, archive, name):
    """Ingest ``archive`` as ``name`` with each package; returns the two
    dataset dirs after checking they hold the same files, byte for byte."""
    j_out = jconv.ingest_tarball(archive, name, str(tmp_path / "jax"))
    t_out = tconv.ingest_tarball(archive, name, str(tmp_path / "torch"))
    jf, tf = _files(j_out), _files(t_out)
    assert sorted(tf) == sorted(jf) and len(tf) >= 3
    for rel in jf:
        assert tf[rel] == jf[rel], rel
    return j_out, t_out


def _saint_pkg(tmp_path, n=40, multilabel=False):
    rng = np.random.default_rng(0)
    a = sp.random(n, n, density=0.15, format="csr", random_state=1)
    a = ((a + a.T) > 0).astype(bool)
    sd = tmp_path / "saint_pkg"
    os.makedirs(sd)
    sp.save_npz(sd / "adj_full.npz", a.tocsr())
    sp.save_npz(sd / "adj_train.npz", a[:, :].tocsr())
    np.save(sd / "feats.npy", rng.normal(size=(n, 4)).astype(np.float32))
    cm = ({str(i): [int(i % 2), int(i % 3 == 0)] for i in range(n)} if multilabel
          else {str(i): int(i % 3) for i in range(n)})
    json.dump(cm, open(sd / "class_map.json", "w"))
    json.dump({"tr": list(range(0, 20)), "va": list(range(20, 30)),
               "te": list(range(30, 40))}, open(sd / "role.json", "w"))
    return sd


def _wcsv(path, arr, fmt="{}"):
    with gzip.open(path, "wt") as f:
        for row in (arr[:, None] if arr.ndim == 1 else arr):
            f.write(",".join("" if (isinstance(x, float) and np.isnan(x))
                             else fmt.format(x) for x in row.tolist()) + "\n")


def _ogb_node_pkg(tmp_path, n=300, e=1500):
    rng = np.random.default_rng(1)
    pkg = tmp_path / "arxiv_pkg"
    raw_d, split_d = pkg / "raw", pkg / "split" / "time"
    os.makedirs(raw_d), os.makedirs(split_d)
    _wcsv(raw_d / "edge.csv.gz", np.stack([rng.integers(0, n, e),
                                           rng.integers(0, n, e)], 1))
    _wcsv(raw_d / "num-node-list.csv.gz", np.array([n]))
    _wcsv(raw_d / "node-feat.csv.gz", np.round(rng.normal(size=(n, 3)), 4),
          "{:.4f}")
    label = rng.integers(0, 4, n).astype(np.float64)
    label[[3, 77]] = np.nan                  # unlabelled nodes: empty fields
    _wcsv(raw_d / "node-label.csv.gz", label, "{:.0f}")
    _wcsv(split_d / "train.csv.gz", np.arange(0, 180))
    _wcsv(split_d / "valid.csv.gz", np.arange(180, 240))
    _wcsv(split_d / "test.csv.gz", np.arange(240, 300))
    return pkg


def test_ingest_shadow_layout(tmp_path):
    g = make_synthetic_dataset(num_nodes=300, avg_deg=6, num_feat=5,
                               num_classes=3, seed=0)
    j_save(str(tmp_path / "stage"), "flickr", indptr=g.indptr_full,
           indices=g.indices_full, feat=g.feat_full, label=g.label_full,
           node_set=g.node_set)
    arc = _tar(str(tmp_path / "stage" / "flickr"), tmp_path / "flickr.tar.gz")
    _ingest_both(tmp_path, arc, "flickr")
    raw = t_load(str(tmp_path / "torch"), "flickr",
                 {"to_undirected": False, "transductive": True})
    assert raw.num_nodes == 300


@pytest.mark.parametrize("multilabel", [False, True])
def test_ingest_saint_layout(tmp_path, multilabel):
    arc = _tar(str(_saint_pkg(tmp_path, multilabel=multilabel)),
               tmp_path / "reddit.tar.gz")
    _ingest_both(tmp_path, arc, "reddit")
    cfg = {"to_undirected": False, "transductive": False}
    jr, tr = j_load(str(tmp_path / "jax"), "reddit", cfg), t_load(
        str(tmp_path / "torch"), "reddit", cfg)
    assert tr.indptr_train is not None and tr.node_set[TRAIN].size == 20
    np.testing.assert_array_equal(tr.label_full, jr.label_full)
    np.testing.assert_array_equal(tr.feat_full, jr.feat_full)


def test_convert_saint(tmp_path):
    sd = _saint_pkg(tmp_path)
    jconv.convert_saint(str(tmp_path / "jax"), "yelp", str(sd))
    tconv.convert_saint(str(tmp_path / "torch"), "yelp", str(sd))
    assert _files(tmp_path / "jax") == _files(tmp_path / "torch")


@pytest.mark.parametrize("archive", ["tar", "zip"])
def test_ingest_ogb_node_csv(tmp_path, archive):
    pkg = _ogb_node_pkg(tmp_path)
    arc = (_tar(str(pkg), tmp_path / "arxiv.tar.gz") if archive == "tar"
           else _zip(str(pkg), tmp_path / "arxiv.zip"))
    _ingest_both(tmp_path, arc, "arxiv")
    raw = t_load(str(tmp_path / "torch"), "arxiv",
                 {"to_undirected": True, "transductive": True})
    assert raw.feat_full.shape == (300, 3) and raw.node_set[VALID].size == 60
    assert raw.label_full[3] == -1 and raw.label_full[77] == -1


def test_ingest_ogb_node_npz(tmp_path):
    rng = np.random.default_rng(3)
    n = 200
    pkg = tmp_path / "products_pkg"
    raw_d, split_d = pkg / "raw", pkg / "split" / "sales_ranking"
    os.makedirs(raw_d), os.makedirs(split_d)
    np.savez(raw_d / "data.npz", edge_index=rng.integers(0, n, (2, 900)),
             node_feat=rng.normal(size=(n, 6)).astype(np.float32),
             num_nodes_list=np.array([n]))
    np.savez(raw_d / "node-label.npz", node_label=rng.integers(0, 5, (n, 1)))
    for name, ids in (("train", np.arange(0, 120)), ("valid", np.arange(120, 160)),
                      ("test", np.arange(160, 200))):
        np.savez(split_d / f"{name}.npz", ids)
    _ingest_both(tmp_path, _tar(str(pkg), tmp_path / "products.tar.gz"), "products")


def test_ingest_ogb_link_pt(tmp_path):
    rng = np.random.default_rng(2)
    n, e = 250, 1200
    pkg = tmp_path / "collab_pkg"
    raw_d, split_d = pkg / "raw", pkg / "split" / "time"
    os.makedirs(raw_d), os.makedirs(split_d)
    _wcsv(raw_d / "edge.csv.gz", np.stack([rng.integers(0, n, e),
                                           rng.integers(0, n, e)], 1))
    _wcsv(raw_d / "num-node-list.csv.gz", np.array([n]))
    _wcsv(raw_d / "node-feat.csv.gz", np.round(rng.normal(size=(n, 2)), 4),
          "{:.4f}")

    def edges(k):
        return torch.tensor(rng.integers(0, n, (k, 2)))

    torch.save({"edge": edges(300)}, split_d / "train.pt")
    torch.save({"edge": edges(40), "edge_neg": edges(40)}, split_d / "valid.pt")
    torch.save({"edge": edges(40), "edge_neg": edges(40)}, split_d / "test.pt")
    _ingest_both(tmp_path, _tar(str(pkg), tmp_path / "collab.tar.gz"), "collab")
    for sfx in ("", "_with_val"):
        assert os.path.isfile(tmp_path / "torch" / "collab" / f"adj_full_raw{sfx}.npz") \
            or os.path.isfile(tmp_path / "torch" / "collab" / f"adj_full_raw{sfx}.npy")
    raw = t_load(str(tmp_path / "torch"), "collab",
                 {"to_undirected": False, "transductive": True,
                  "valedges_as_input": True})
    assert raw.prediction_task == "link"
    assert raw.edge_set[TRAIN]["pos"].shape == (300, 2)
    assert raw.edge_set[TEST]["neg"].shape == (40, 2)


def test_ingest_refuses_unknown_layout(tmp_path):
    d = tmp_path / "junk"
    os.makedirs(d)
    (d / "readme.txt").write_text("nothing here")
    arc = _tar(str(d), tmp_path / "junk.tar.gz")
    with pytest.raises(ValueError, match="no recognizable dataset layout"):
        tconv.ingest_tarball(arc, "arxiv", str(tmp_path / "torch"))
    with pytest.raises(ValueError, match="unknown dataset"):
        tconv.ingest_tarball(arc, "not_a_dataset", str(tmp_path / "torch"))


CSV_FIXTURES = [
    "1,2\n3,4\n", "1,\n,4\n", "5\n\n7\n", "1,2\n\n3,4\n", "1\n\n\n",
    "1,,,4\n5,6,7,8\n", "\n\n1,2\n3,4", ",,\n1,2,3\n,,\n", "1,2\n\n", "7",
]


@pytest.mark.parametrize("txt", CSV_FIXTURES)
def test_read_csv_gz_edge_cases(tmp_path, txt):
    """Empty fields and lines stay positional (NaN), at every chunk size,
    as in JAX's reader."""
    p = tmp_path / "x.csv"
    p.write_text(txt)
    want = jconv._read_csv_gz(str(p), np.float64)
    for cb in (1, 2, 3, 5, 7, 1 << 20):
        got = tconv._read_csv_gz(str(p), np.float64, chunk_bytes=cb)
        np.testing.assert_array_equal(got, want, err_msg=(txt, cb))


def test_read_csv_gz_streams_a_large_file(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(20_000):
        r = [str(x) for x in rng.integers(0, 100, 4)]
        if i % 97 == 0:
            r[rng.integers(0, 4)] = ""
        rows.append(",".join(r) if i % 401 else "")
    big = tmp_path / "big.csv.gz"
    with gzip.open(big, "wt") as f:
        f.write("\n".join(rows) + "\n")
    want = jconv._read_csv_gz(str(big), np.float64)
    got = tconv._read_csv_gz(str(big), np.float64, chunk_bytes=1 << 12)
    assert got.shape == (20_000, 4)
    np.testing.assert_array_equal(got, want)


def test_read_split_file(tmp_path):
    np.save(tmp_path / "a.npy", np.arange(5))
    np.savez(tmp_path / "b.npz", np.arange(3, 9))
    _wcsv(tmp_path / "c.csv.gz", np.arange(4))
    for name in ("a.npy", "b.npz", "c.csv.gz"):
        np.testing.assert_array_equal(tconv._read_split_file(str(tmp_path / name)),
                                      jconv._read_split_file(str(tmp_path / name)))
    with pytest.raises(ValueError, match="unsupported split file"):
        tconv._read_split_file(str(tmp_path / "d.json"))


def test_loader_autoconvert_dispatch(tmp_path):
    """A missing dataset dir: a DATA_ZOO name goes to the converter (a
    GraphSAINT set needs its distribution dir, an OGB set the ogb
    package), any other name fails on the missing split file, as in
    JAX."""
    cfg = {"to_undirected": False, "transductive": True}
    with pytest.raises(AssertionError, match="GraphSAINT distribution"):
        j_load(str(tmp_path), "flickr", cfg)
    with pytest.raises(ValueError, match="GraphSAINT distribution"):
        t_load(str(tmp_path), "flickr", cfg)
    for load in (j_load, t_load):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path), "not_a_dataset", cfg)
    try:
        import ogb  # noqa: F401
    except ImportError:
        for load in (j_load, t_load):
            with pytest.raises(ImportError, match="ogb"):
                load(str(tmp_path), "arxiv", cfg)


def test_data_zoo_and_files(tmp_path):
    assert sorted(tconv.DATA_ZOO) == sorted(jconv.DATA_ZOO)
    for name, spec in jconv.DATA_ZOO.items():
        for variant, files in spec.items():
            ours = tconv.DATA_ZOO[name][variant]
            assert (ours.prediction_task, ours.required) == (files.prediction_task,
                                                            files.required)
    assert not tconv.DATA_ZOO["arxiv"]["ALL"].have_all_files(str(tmp_path), "arxiv")
    pkg = _ogb_node_pkg(tmp_path)
    tconv.ingest_tarball(_tar(str(pkg), tmp_path / "a.tar.gz"), "arxiv",
                         str(tmp_path / "d"))
    assert tconv.DATA_ZOO["arxiv"]["ALL"].have_all_files(str(tmp_path / "d"), "arxiv")
