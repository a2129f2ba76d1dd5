"""offsetguided_tpu_torch: the PyTorch / CUDA port of offsetguided_tpu.

Runs Hourglass-104 pose inference, COCO evaluation, the GT oracle and
training on an NVIDIA H100: the convolutions go to cuDNN, and the four
decode kernels
(fused x4 bicubic peaks, 2x2-block top-k, fused NMS + top-k at stride
resolution, greedy skeleton grouping) are hand-written CUDA C++ under
`csrc/`, built at first use by `ops/cuda/_build.py`. Every kernel keeps a
plain PyTorch version beside it, which runs only on CPU tensors.

Layer map:
    config/   keypoint taxonomy, skeletons, flip tables, dataclass configs
    models/   Hourglass-104 backbone, fused 1x1 heads, train-mode
              BatchNorm with the JAX semantics, JAX and reference weight
              import, training checkpoints
    ops/      normalize, resize, GT encoder, mask downscale, device
              augmentation, losses, peak finding, limb collection, grouping
    ops/cuda/ kernel loader and wrappers; csrc/ holds the CUDA sources
    decoder/  PostProcessor: flip merge, decode routes, grouping
    data/     eval-time rescale + pad, inverse transform, COCO index, masks,
              image reading, the JPEG / PNG codec (csrc/codec.cpp),
              drawing, augmentation parameters, the training dataset and
              batch iterator, the hard synthetic benchmark
    eval/     preprocess, batched forward + decode, COCO records, OKS AP
    parallel/ the train step, optimizers and LR schedules
    utils/    meters, JSON logging, profiling (traces, device time)
    cli/      the HTTP pose server, evaluate, simulate (oracle), train,
              self-check, and the measurement tools (bench, bench_serve,
              bench_e2e, bench_data, profile_forward, profile_decode)

The package never imports JAX or the JAX package.
"""

__version__ = "0.1.0"
