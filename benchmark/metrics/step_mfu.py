"""The whole step's share of the cards' f32 peak: the model's FLOPs a
subgraph (``peaks.forward_flops`` at the configuration's widths and the
cell's mean real nodes and edges a subgraph, times the entry's forwards
a root: three for a TRAIN step) times the measured rate of the run's
window, over 67 TFLOP/s a card."""
from benchmark import peaks


def read(ctx):
    sub = ctx.get("subgraph")
    if not sub or ctx["rate"] <= 0:
        return None
    per = peaks.forward_flops(ctx["config"], sub["nodes"], sub["edges"])
    per *= ctx["forwards_per_root"]
    return 100.0 * per * ctx["rate"] / (peaks.F32_FLOP_PER_S * ctx["chips"])
