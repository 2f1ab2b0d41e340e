from repro_torch.common import tree
from repro_torch.common.tree import (
    param_count,
    param_bytes,
    tree_cast,
    global_norm,
    path_map,
)

__all__ = ["tree", "param_count", "param_bytes", "tree_cast", "global_norm",
           "path_map"]
