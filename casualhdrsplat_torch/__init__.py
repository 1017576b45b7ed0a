"""casualhdrsplat_torch — the PyTorch/CUDA port of casualhdrsplat_tpu.

The JAX package beside it is the reference; this package imports nothing
from it.  Sub-packages keep the reference's layout and names so each
function has an obvious counterpart.  Every entry point takes a `device`
that defaults to "cuda"; the CPU is used only when the caller asks for it
(the tests do), and a kernel wrapper takes its plain PyTorch version only
for tensors that lie on the CPU.

Pose and Lie math must run in full float32: a reduced-precision matmul in
the pose chain puts about a degree of rotation error into every render
(CLAUDE.md, "Environment rules").  TF32 is therefore switched off here,
once, for the whole package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
