"""physimglobalpose_tpu_torch - the PyTorch/CUDA port of physimglobalpose_tpu.

The same 6D pose-estimation pipeline (RGB-D preprocessing, StoCS congruent-set
hypotheses, weighted-LCP scoring, ICP polish) written in PyTorch for one
NVIDIA H100. Plain tensor code is PyTorch; the weighted-LCP scorer is a
hand-written CUDA kernel (csrc/lcp_segside.cu). The JAX package beside it is
the reference that the tests hold this package against.
"""

__version__ = "0.1.0"

from physimglobalpose_tpu_torch.config import (  # noqa: F401
    PipelineConfig,
    StoCSConfig,
    LCPConfig,
    ICPConfig,
    PhysicsConfig,
    RenderConfig,
    MCTSConfig,
    PreprocessConfig,
)
