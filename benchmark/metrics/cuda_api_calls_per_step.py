"""The host's calls into the CUDA libraries in the traced slice (rank
0), over the steps it ran."""


def read(ctx):
    t, traced = ctx.get("trace"), ctx.get("traced")
    if not t or not traced or traced["steps"] <= 0:
        return None
    return t["runtime_calls"] / traced["steps"]
