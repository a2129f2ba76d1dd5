"""offsetguided_tpu_torch: the PyTorch / CUDA port of offsetguided_tpu.

Runs Hourglass-104 pose inference on an NVIDIA H100: the convolutions go to
cuDNN, and the two decode kernels (peak finding on the x4 bicubic heatmap,
greedy skeleton grouping) are hand-written CUDA C++ under `csrc/`, built at
first use by `ops/cuda/_build.py`. Every kernel keeps a plain PyTorch version
beside it, which runs only on CPU tensors.

Layer map:
    config/   keypoint taxonomy, skeletons, flip tables, dataclass configs
    models/   Hourglass-104 backbone, fused 1x1 heads, JAX weight import
    ops/      normalize, resize, peak finding, limb collection, grouping
    ops/cuda/ kernel loader and wrappers; csrc/ holds the CUDA sources
    decoder/  PostProcessor: flip merge, decode, grouping
    data/     eval-time rescale + pad and the inverse transform
    eval/     preprocess, batched forward + decode, COCO records
    cli/      serving core (micro-batcher)

The package never imports JAX or the JAX package.
"""

__version__ = "0.1.0"
