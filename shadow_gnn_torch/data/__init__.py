from shadow_gnn_torch.data.graph import DeviceGraph, RawGraph  # noqa: F401
from shadow_gnn_torch.data.synthetic import make_synthetic_dataset  # noqa: F401
from shadow_gnn_torch.data.format import save_shadow_format  # noqa: F401
from shadow_gnn_torch.data.loader import load_data  # noqa: F401
