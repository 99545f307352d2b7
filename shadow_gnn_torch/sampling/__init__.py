from shadow_gnn_torch.sampling.batch import (SamplerConfig, SubgraphBatch,  # noqa: F401
                                             default_n_pad)
from shadow_gnn_torch.sampling.ppr import ppr_push_host, ppr_topk_tables  # noqa: F401
