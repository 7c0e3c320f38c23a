"""rxmd_tpu_torch: the ReaxFF MD engine of rxmd_tpu in PyTorch, with the
cell-column pair sweeps as hand-written CUDA kernels for Hopper (sm_90a).

Public functions keep rxmd_tpu's names and array layouts; this package
imports torch and never jax.
"""
import torch as _torch

# Position transforms (frac @ H.T) and the strain virial are float32
# matmuls on the card; TF32 would round positions to ~1e-3 relative and
# break QEq convergence, so both TF32 switches stay off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
