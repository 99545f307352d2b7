"""The node cells' inputs, pinned byte for byte: at the tests' small
sizes on the CPU, one seed's data (every array of ``gen.make_dataset``),
weights (``gen.make_weights``) and the reference's subgraphs of the
first 32 TRAIN roots hash as they did before ``gen.py`` learned the link
task, so that nothing a link configuration adds moves what a node cell
draws or judges."""
import hashlib

import numpy as np
import pytest
import torch

from benchmark import gen, harness, runner, verify
from benchmark.tests.conftest import small

SEED = 2**31 + 77
DATA_KEYS = ("indptr", "indices", "indptr_train", "indices_train", "feat", "label",
             "node_set")
PINS = {
    ("sage3_flickr.train", "data"):
        "cba9a76e3cd0480a2b53cdcb1588cdaa3f8184237fe1b3cd729476e2163f887f",
    ("sage3_flickr.train", "weights"):
        "8e8cac63417de06c77e0d6fc6773a0e88167241efaf74c8a770c9b4eb12fb928",
    ("sage3_flickr.train", "subgraphs"):
        "0b9a892c3030e4299054094320f7b66f4919a55cc37483147ba9c18f17728813",
    ("gat5_products.train", "data"):
        "8b92d8c11d8ba68920a2a2bb91ba1328cea3d0c52df9326f662a5283f90e05d9",
    ("gat5_products.train", "weights"):
        "220f5d58aec494509968f7ff66c920d14e1bfb30d2fab543077adcf4c06a545d",
    ("gat5_products.train", "subgraphs"):
        "27d7ec90fe2979f6ec84e724953820f4c5d22f06dfb2099763fb9409dfffa708",
}


def digest(arrays) -> str:
    """sha256 over (name, dtype, shape, bytes) of each array in order; a
    None carries its name alone."""
    h = hashlib.sha256()
    for name, a in arrays:
        if a is None:
            h.update(f"{name} None;".encode())
            continue
        a = np.ascontiguousarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
        h.update(f"{name} {a.dtype} {a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def inputs(cell_name: str, part: str):
    """[(name, array)] of one part of the cell's inputs at the small sizes."""
    cell = harness.load_cell(cell_name, overrides=small(cell_name))
    cfg = cell["config"]
    if part == "data":
        d = gen.make_dataset(cfg["data"], SEED, "cpu")
        assert d.get("edge_set") is None
        out = []
        for k in DATA_KEYS:
            if isinstance(d[k], dict):
                out += [(f"{k}.{m}", d[k][m]) for m in sorted(d[k])]
            else:
                out.append((k, d[k]))
        return out
    if part == "weights":
        specs = runner.reference_model(cfg).param_specs(cfg)
        return sorted(gen.make_weights(specs, SEED, "cpu").items())
    ref = verify.Reference(cell, SEED, "cpu")
    sub = ref.subgraphs(verify.TRAIN, ref.data["node_set"][verify.TRAIN][:32])
    return sorted(sub.items())


@pytest.mark.parametrize("cell,part", sorted(PINS), ids=[f"{c}-{p}" for c, p in sorted(PINS)])
def test_node_inputs_pinned(cell, part):
    assert digest(inputs(cell, part)) == PINS[(cell, part)]
