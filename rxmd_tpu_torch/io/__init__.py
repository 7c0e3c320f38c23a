"""Configuration and trajectory files (counterpart of rxmd_tpu.io).

The file formats are numpy and plain text; a tensor on any device reaches
them through `host`, one copy to host memory.
"""
import numpy as np
import torch


def host(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
