"""Dataset conversion: OGB / GraphSAINT -> shaDow on-disk format (numpy).

The port's own copy of ``shadow_gnn_tpu/data/converter.py`` (reference
``frontend/data_converter.py``): the DATA_ZOO registry of the supported
datasets with their required files, ``convert2shadow``, which writes the
canonical directory layout (``data/format.py``), and
:func:`ingest_tarball` (``--data_tarball``), which reads a local archive
of the shaDow, GraphSAINT or OGB raw layout.  Both packages write the
same files, byte for byte, from the same input.

The OGB converters (``convert_ogb_node`` / ``convert_ogb_link``) need
the ``ogb`` package and a network to download from; without the package
they raise its ImportError, as the JAX package's do.  The GraphSAINT
format (adj_full.npz/adj_train.npz/feats.npy/class_map.json/role.json)
and every archive need only local files.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from shadow_gnn_torch import TRAIN, VALID, TEST
from shadow_gnn_torch.data import format as fmt


@dataclass
class ShaDowFiles:
    """Required-file spec per (dataset, task-variant), mirroring the
    ShaDowFiles dataclasses of data_converter.py:25-104."""

    prediction_task: str                  # 'node' | 'link'
    required: List[str] = field(default_factory=lambda: [
        "adj_full_raw", "feat_full.npy", "label_full.npy", "split.npy"])
    optional: List[str] = field(default_factory=list)

    def have_all_files(self, prefix: str, name: str) -> bool:
        d = f"{prefix}/{name}"
        for f in self.required:
            if f == "adj_full_raw":
                if not (os.path.isfile(f"{d}/adj_full_raw.npz")
                        or os.path.isfile(f"{d}/adj_full_raw.npy")):
                    return False
            elif f == "adj_train_raw":
                if not (os.path.isfile(f"{d}/adj_train_raw.npz")
                        or os.path.isfile(f"{d}/adj_train_raw.npy")):
                    return False
            elif not os.path.isfile(f"{d}/{f}"):
                return False
        return True


_NODE = ShaDowFiles("node")
_NODE_IND = ShaDowFiles("node", required=[
    "adj_full_raw", "adj_train_raw", "feat_full.npy", "label_full.npy",
    "split.npy"])
_LINK = ShaDowFiles("link", required=["adj_full_raw", "feat_full.npy",
                                      "split.npy"])

# the 8 supported datasets (data_converter.py:117-150)
DATA_ZOO: Dict[str, Dict[str, ShaDowFiles]] = {
    "flickr":     {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE_IND},
    "reddit":     {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE_IND},
    "yelp":       {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE_IND},
    "arxiv":      {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE},
    "products":   {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE},
    "papers100M": {"ALL": _NODE, "transductive": _NODE, "inductive": _NODE},
    "collab":     {"ALL": _LINK, "with_val_edges": _LINK, "no_val_edges": _LINK},
    "ppa":        {"ALL": _LINK, "with_val_edges": _LINK, "no_val_edges": _LINK},
}

OGB_NAME = {"arxiv": "ogbn-arxiv", "products": "ogbn-products",
            "papers100M": "ogbn-papers100M", "collab": "ogbl-collab",
            "ppa": "ogbl-ppa"}
SAINT_DATASETS = {"flickr", "reddit", "yelp"}


def _coo_to_csr(src, dst, n):
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    dtype = np.int32 if max(n, dst.size) < 2**31 else np.int64
    return indptr.astype(dtype), dst.astype(dtype)


def convert_saint(prefix: str, name: str, saint_dir: str):
    """GraphSAINT format -> shaDow (data_converter.py:313-416)."""
    import scipy.sparse as sp
    adj_full = sp.load_npz(f"{saint_dir}/adj_full.npz").astype(bool)
    adj_train = sp.load_npz(f"{saint_dir}/adj_train.npz").astype(bool)
    role = json.load(open(f"{saint_dir}/role.json"))
    feats = np.load(f"{saint_dir}/feats.npy")
    class_map = json.load(open(f"{saint_dir}/class_map.json"))
    n = adj_full.shape[0]
    class_map = {int(k): v for k, v in class_map.items()}
    v0 = next(iter(class_map.values()))
    if isinstance(v0, list):
        label = np.zeros((n, len(v0)), np.float32)
        for k, v in class_map.items():
            label[k] = v
    else:
        label = np.zeros(n, np.int64)
        for k, v in class_map.items():
            label[k] = v
    node_set = {TRAIN: np.asarray(role["tr"], np.int64),
                VALID: np.asarray(role["va"], np.int64),
                TEST: np.asarray(role["te"], np.int64)}
    return fmt.save_shadow_format(
        prefix, name, indptr=adj_full.indptr.astype(np.int64),
        indices=adj_full.indices, feat=feats, label=label, node_set=node_set,
        indptr_train=adj_train.indptr.astype(np.int64),
        indices_train=adj_train.indices)


def convert_ogb_node(prefix: str, name: str):
    """OGB node-property dataset -> shaDow (data_converter.py:164-242)."""
    from ogb.nodeproppred import NodePropPredDataset
    ds = NodePropPredDataset(name=OGB_NAME[name], root=f"{prefix}/_ogb")
    split = ds.get_idx_split()
    graph, label = ds[0]
    n = graph["num_nodes"]
    src, dst = graph["edge_index"][0], graph["edge_index"][1]
    indptr, indices = _coo_to_csr(src.astype(np.int64), dst.astype(np.int64), n)
    label = label.squeeze()
    node_set = {TRAIN: np.asarray(split["train"], np.int64),
                VALID: np.asarray(split["valid"], np.int64),
                TEST: np.asarray(split["test"], np.int64)}
    return fmt.save_shadow_format(
        prefix, name, indptr=indptr, indices=indices,
        feat=graph["node_feat"], label=label, node_set=node_set)


def convert_ogb_link(prefix: str, name: str):
    """OGB link-property dataset -> shaDow (data_converter.py:244-311)."""
    from ogb.linkproppred import LinkPropPredDataset
    ds = LinkPropPredDataset(name=OGB_NAME[name], root=f"{prefix}/_ogb")
    split = ds.get_edge_split()
    graph = ds[0]
    n = graph["num_nodes"]
    src, dst = graph["edge_index"][0], graph["edge_index"][1]
    indptr, indices = _coo_to_csr(src.astype(np.int64), dst.astype(np.int64), n)
    edge_set = {
        TRAIN: {"pos": np.asarray(split["train"]["edge"], np.int64)},
        VALID: {"pos": np.asarray(split["valid"]["edge"], np.int64),
                "neg": np.asarray(split["valid"]["edge_neg"], np.int64)},
        TEST: {"pos": np.asarray(split["test"]["edge"], np.int64),
               "neg": np.asarray(split["test"]["edge_neg"], np.int64)},
    }
    # alternative adj_full with validation edges added both directions
    # (reference data_converter.py:357-373); always converted so a later
    # valedges_as_input run needs no re-download
    val = np.asarray(split["valid"]["edge"], np.int64)
    src_wv = np.concatenate([src.astype(np.int64), val[:, 0], val[:, 1]])
    dst_wv = np.concatenate([dst.astype(np.int64), val[:, 1], val[:, 0]])
    key = np.unique(src_wv * n + dst_wv)
    indptr_wv, indices_wv = _coo_to_csr(key // n, key % n, n)
    return fmt.save_shadow_format(
        prefix, name, indptr=indptr, indices=indices,
        feat=graph["node_feat"], label=None, edge_set=edge_set,
        indptr_with_val=indptr_wv, indices_with_val=indices_wv)


def convert2shadow(name_data: str, prefix: str,
                   saint_dir: Optional[str] = None):
    """Entry point, like reference convert2shaDow (data_converter.py:419)."""
    if name_data not in DATA_ZOO:
        raise ValueError(f"unknown dataset {name_data}")
    if name_data in SAINT_DATASETS:
        if not saint_dir:
            raise ValueError(
                f"{name_data} uses the GraphSAINT distribution; pass the "
                f"directory holding adj_full.npz/feats.npy/...")
        return convert_saint(prefix, name_data, saint_dir)
    if DATA_ZOO[name_data]["ALL"].prediction_task == "node":
        return convert_ogb_node(prefix, name_data)
    return convert_ogb_link(prefix, name_data)


# ---------------------------------------------------------------------------
# Zero-egress archive ingestion (--data_tarball).
#
# On a machine without a network the OGB downloads
# (``convert_ogb_node/link``) cannot run; the reference assumes a
# machine that can reach snap.stanford.edu.  This hook accepts a
# user-provided archive of any of the three distributions and produces
# the same shaDow directory the downloader would have:
#
#   * shaDow layout      — adj_full_raw.np[yz] + feat_full.npy + ... :
#                          files are copied through unchanged;
#   * GraphSAINT layout  — adj_full.npz/adj_train.npz/feats.npy/
#                          class_map.json/role.json (flickr/reddit/yelp);
#   * OGB raw layout     — raw/edge.csv.gz (+ node-feat/node-label/
#                          num-node-list) or raw/data.npz, with
#                          split/<type>/{train,valid,test}.{csv.gz,pt,npz}
#                          — parsed directly with numpy/torch, NO ``ogb``
#                          package needed.
# ---------------------------------------------------------------------------


def _extract_archive(tarball: str, staging: str) -> str:
    import tarfile
    import zipfile
    os.makedirs(staging, exist_ok=True)
    if zipfile.is_zipfile(tarball):
        with zipfile.ZipFile(tarball) as z:
            z.extractall(staging)
    else:
        with tarfile.open(tarball) as t:
            t.extractall(staging, filter="data")
    return staging


def _find_dir_with(root: str, filenames) -> Optional[str]:
    """Innermost (deepest) directory containing ALL of ``filenames``
    (any of the alternatives when an entry is a tuple) — a wrapper dir
    with stray same-named files never shadows the real nested layout."""
    for d, _, files in sorted(os.walk(root),
                              key=lambda w: (-w[0].count(os.sep), w[0])):
        fs = set(files)
        ok = True
        for f in filenames:
            alts = f if isinstance(f, tuple) else (f,)
            if not any(a in fs for a in alts):
                ok = False
                break
        if ok:
            return d
    return None


def _parse_csv_block(txt: str, ncol: int, dtype) -> np.ndarray:
    """Parse ONE block of complete CSV lines (joined by '\\n', NO
    terminator on the last line) into a flat array.

    Empty fields/lines are pandas' NaN na_rep in OGB raw CSVs; they
    must stay POSITIONAL — the fast whitespace split would collapse
    them and silently shift every following value.  Normalize them to
    the literal 'nan' TEXTUALLY (all C-speed replaces, no per-value
    python loop), then the vectorized parse handles everything.  A
    block ENDING with '\\n' carries a trailing empty line (= one full
    NaN row) — the streaming caller cuts chunks at line boundaries, so
    an empty line landing exactly on a chunk boundary arrives here as
    that trailing newline.
    """
    has_empty = (",," in txt or ",\n" in txt or "\n," in txt
                 or "\n\n" in txt or txt.startswith((",", "\n"))
                 or txt.endswith((",", "\n")) or txt == "")
    if has_empty:
        empty_row = ",".join(["nan"] * ncol)
        if ncol > 1:
            while ",," in txt:                      # adjacent empties
                txt = txt.replace(",,", ",nan,")
            txt = txt.replace(",\n", ",nan\n").replace("\n,", "\nnan,")
            if txt.startswith(","):
                txt = "nan" + txt
            if txt.endswith(","):
                txt += "nan"
        # empty LINES -> full NaN rows (single-col: each is one nan)
        while "\n\n" in txt:
            txt = txt.replace("\n\n", "\n" + empty_row + "\n")
        if txt.startswith("\n"):
            txt = empty_row + txt
        if txt.endswith("\n") or txt == "":
            txt += empty_row
    return np.array(txt.replace(",", " ").split(), np.float64).astype(dtype)


def _read_csv_gz(path: str, dtype, chunk_bytes: int = 64 << 20) -> np.ndarray:
    """Numeric CSV (possibly .gz) -> ndarray, no pandas dependency.

    STREAMED in bounded text chunks (the reference reads these files
    through pandas' C reader, data_converter.py:164-242): a
    papers100M-class node-feat CSV is ~50+ GB of text, so the file is
    never materialized as one Python str.  Chunks are cut at the last
    line boundary (the partial tail line carries over), each block of
    complete lines is normalized/parsed independently at C speed, and
    per-block results are converted to the target dtype immediately —
    peak transient memory is O(chunk_bytes) text + one extra copy of
    the OUTPUT array at the final concatenate, never O(file) text.

    Semantics: exactly ONE terminator newline is stripped (the text
    after the file's last '\\n' is the final row; '' means the file was
    newline-terminated); further trailing newlines are trailing empty
    rows (NaN rows) and are preserved.  Empty fields/lines spanning
    chunk boundaries parse identically to the whole-file read because
    blocks always hold complete lines (see _parse_csv_block).
    """
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    parts, carry, ncol = [], "", None
    with opener(path, "rt") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            carry += chunk
            cut = carry.rfind("\n")
            if cut < 0:
                continue                             # no complete line yet
            block, carry = carry[:cut], carry[cut + 1:]
            if ncol is None:
                first_data = block.lstrip("\n")
                if not first_data:
                    # only empty lines so far — row width still unknown;
                    # put the block back until a data line arrives
                    carry = block + "\n" + carry
                    continue
                ncol = first_data.split("\n", 1)[0].count(",") + 1
            parts.append(_parse_csv_block(block, ncol, dtype))
    # EOF: carry is the text after the last '\n' (no newline in it) —
    # the final unterminated row, or '' for the stripped terminator
    if carry != "" or ncol is None:
        if ncol is None:                             # no '\n' in the file
            ncol = carry.split("\n", 1)[0].count(",") + 1
        parts.append(_parse_csv_block(carry, ncol, dtype))
    flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return flat.reshape(-1, ncol) if ncol > 1 else flat


def _read_split_file(path: str) -> np.ndarray:
    if path.endswith((".csv.gz", ".csv")):
        return _read_csv_gz(path, np.int64).reshape(-1)
    if path.endswith(".npz") or path.endswith(".npy"):
        z = np.load(path, allow_pickle=True)
        return np.asarray(z[z.files[0]] if hasattr(z, "files") else z,
                          np.int64).reshape(-1)
    raise ValueError(f"unsupported split file {path}")


def _find_split_dir(root: str):
    """OGB split dir: split/<split_type>/ holding train.* files."""
    for d, _, files in sorted(os.walk(root)):
        if os.path.basename(d) == "raw":
            continue
        if any(f.startswith("train.") for f in files) and \
                any(f.startswith("valid.") for f in files) and \
                any(f.startswith("test.") for f in files):
            return d
    return None


def _ingest_ogb_raw(prefix: str, name: str, raw_dir: str, split_dir: str,
                    task: str):
    """Parse an extracted OGB raw/ + split/ tree without the ogb pkg."""
    npz_path = os.path.join(raw_dir, "data.npz")
    if os.path.isfile(npz_path):
        z = np.load(npz_path)
        edge = np.asarray(z["edge_index"], np.int64)
        src, dst = edge[0], edge[1]
        feat = np.asarray(z["node_feat"], np.float32) \
            if "node_feat" in z.files else None
        n = int(z["num_nodes_list"][0]) if "num_nodes_list" in z.files \
            else int(max(src.max(), dst.max()) + 1)
        label = None
        lab_npz = os.path.join(raw_dir, "node-label.npz")
        if "node_label" in z.files:
            label = np.asarray(z["node_label"]).squeeze()
        elif os.path.isfile(lab_npz):
            lz = np.load(lab_npz)
            label = np.asarray(lz[lz.files[0]]).squeeze()
    else:
        edge = _read_csv_gz(_first_existing(raw_dir, "edge.csv.gz",
                                            "edge.csv"), np.int64)
        src, dst = edge[:, 0], edge[:, 1]
        nn = _first_existing(raw_dir, "num-node-list.csv.gz",
                             "num-node-list.csv", required=False)
        n = int(_read_csv_gz(nn, np.int64).reshape(-1)[0]) if nn \
            else int(max(src.max(), dst.max()) + 1)
        ff = _first_existing(raw_dir, "node-feat.csv.gz", "node-feat.csv",
                             required=False)
        feat = _read_csv_gz(ff, np.float32).reshape(n, -1) if ff else None
        lf = _first_existing(raw_dir, "node-label.csv.gz", "node-label.csv",
                             required=False)
        label = _read_csv_gz(lf, np.float64).squeeze() if lf else None
    if feat is None:
        feat = np.zeros((n, 1), np.float32)   # featureless (e.g. ppa)
    indptr, indices = _coo_to_csr(src, dst, n)

    def split_file(base):
        for ext in (".csv.gz", ".csv", ".pt", ".npz", ".npy"):
            p = os.path.join(split_dir, base + ext)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"{split_dir}/{base}.*")

    if task == "node":
        if label is not None and label.ndim == 1:
            label = np.nan_to_num(label, nan=-1).astype(np.int64)
        node_set = {m: _read_split_file(split_file(b)) for m, b in
                    ((TRAIN, "train"), (VALID, "valid"), (TEST, "test"))}
        return fmt.save_shadow_format(prefix, name, indptr=indptr,
                                      indices=indices, feat=feat,
                                      label=label, node_set=node_set)
    # link task: splits are torch pickles {edge: [E,2], edge_neg: ...}
    import torch
    sp = {b: torch.load(split_file(b), map_location="cpu",
                        weights_only=False)
          for b in ("train", "valid", "test")}

    def edges(d, key):
        e = d[key]
        return np.asarray(e.numpy() if hasattr(e, "numpy") else e, np.int64)

    edge_set = {
        TRAIN: {"pos": edges(sp["train"], "edge")},
        VALID: {"pos": edges(sp["valid"], "edge"),
                "neg": edges(sp["valid"], "edge_neg")},
        TEST: {"pos": edges(sp["test"], "edge"),
               "neg": edges(sp["test"], "edge_neg")},
    }
    val = edge_set[VALID]["pos"]
    src_wv = np.concatenate([src, val[:, 0], val[:, 1]])
    dst_wv = np.concatenate([dst, val[:, 1], val[:, 0]])
    key = np.unique(src_wv * n + dst_wv)
    indptr_wv, indices_wv = _coo_to_csr(key // n, key % n, n)
    return fmt.save_shadow_format(prefix, name, indptr=indptr,
                                  indices=indices, feat=feat, label=None,
                                  edge_set=edge_set,
                                  indptr_with_val=indptr_wv,
                                  indices_with_val=indices_wv)


def _first_existing(d: str, *names, required: bool = True):
    for nm in names:
        p = os.path.join(d, nm)
        if os.path.isfile(p):
            return p
    if required:
        raise FileNotFoundError(f"none of {names} under {d}")
    return None


def ingest_tarball(tarball: str, name_data: str, prefix: str,
                   staging: Optional[str] = None) -> str:
    """Ingest a user-provided dataset archive (zero egress) and
    materialize ``<prefix>/<name_data>/`` in shaDow format.

    Auto-detects the archive's distribution layout; see module comment.
    Returns the dataset directory.
    """
    if name_data not in DATA_ZOO:
        raise ValueError(f"unknown dataset {name_data}")
    import shutil
    import tempfile
    own_staging = staging is None
    staging = staging or tempfile.mkdtemp(prefix="shadow_ingest_")
    try:
        _extract_archive(tarball, staging)
        out_dir = f"{prefix}/{name_data}"
        # 1) already shaDow: copy files through
        d = _find_dir_with(staging, [("adj_full_raw.npy", "adj_full_raw.npz"),
                                     "feat_full.npy", "split.npy"])
        if d:
            os.makedirs(out_dir, exist_ok=True)
            for f in os.listdir(d):
                src_p = os.path.join(d, f)
                if os.path.isfile(src_p):
                    shutil.copy2(src_p, os.path.join(out_dir, f))
            return out_dir
        # 2) GraphSAINT
        d = _find_dir_with(staging, ["adj_full.npz", "feats.npy",
                                     "class_map.json", "role.json"])
        if d:
            return convert_saint(prefix, name_data, d)
        # 3) OGB raw
        raw = _find_dir_with(staging, [("edge.csv.gz", "edge.csv",
                                        "data.npz")])
        split_dir = _find_split_dir(staging)
        if raw and split_dir:
            task = DATA_ZOO[name_data]["ALL"].prediction_task
            return _ingest_ogb_raw(prefix, name_data, raw, split_dir, task)
        raise ValueError(
            f"{tarball}: no recognizable dataset layout (need shaDow, "
            f"GraphSAINT, or OGB raw files)")
    finally:
        if own_staging:
            shutil.rmtree(staging, ignore_errors=True)

