"""PyTorch + CUDA port of fluorosequencingimageanalysis_tpu.

The experiment step (registration -> candidate map -> 5x5 LM fit -> NMS ->
spot compaction -> photometry) runs on one device:

    from fluorosequencingimageanalysis_torch.api import Pipeline
    out = Pipeline(device="cuda").run_stack(stack)   # [F, C, H, W]

Module names mirror the JAX package so each counterpart is easy to find.
The two hand-written CUDA kernels (csrc/) are built with nvcc at first use;
on CPU tensors every wrapper runs its plain PyTorch twin instead. This
package never imports jax.
"""

from . import _device  # noqa: F401  (pins TF32 off)

