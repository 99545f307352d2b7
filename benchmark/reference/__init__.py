"""The plain reference of the benchmark's cells: PyTorch and NumPy only.

It imports nothing of the program (``shadow_gnn_torch``), nor ``jax``,
nor ``shadow_gnn_tpu``, and takes nothing that the program made: it is
handed the inputs that ``benchmark/gen.py`` draws from the seed (the
graph, features, labels, splits, weights) and works out again from them
the PPR top-k tables (``ppr.py``), the subgraphs (``subgraph.py``), the
model (one module per architecture, named by the configuration's
``reference`` key: ``sage.py``) and the update (``optim.py``).  Each
function follows the published shaDow-GNN definition; where the
program fixes a free choice (which random draws make a dropout mask,
the dropedge hash), the reference reproduces that choice from the
program's documented definition, from the seed.
"""
